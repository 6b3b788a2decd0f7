"""The harness's own sink: the hand-off to an encoder or a live output.

It keeps no frame (``KEEPS_PAYLOAD`` False, as fakesink), stamps each
frame's arrival on the host clock, and copies the bytes of the frames that
the check reads into buffers made in set-up.
"""

from __future__ import annotations

import time

import numpy as np
import torch

ELEMENT = "vfbenchsink"
_CLASS = None


def register():
    """Register the sink with the program's element registry (once)."""
    global _CLASS
    if _CLASS is not None:
        return _CLASS
    from tpuvf_torch.core.element import SinkElement
    from tpuvf_torch.core.registry import register as reg

    class BenchSink(SinkElement):
        """Stamps each frame's arrival; keeps the sampled frames' bytes."""

        KEEPS_PAYLOAD = False
        ELEMENT_NAME = ELEMENT
        DESCRIPTION = "vfbench's sink: arrival stamps, sampled bytes"

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.arm(0, {})

        def arm(self, n: int, keep: dict) -> None:
            """Expect frames 0..n-1; copy frame k into keep[k]."""
            self.arrivals = np.full(n, np.nan)
            self.keep = keep
            self.kept = set()
            self.received = 0

        def consume(self, host_frame, spec, frame_index):
            now = time.perf_counter()
            with torch.profiler.record_function("vfbench.sink"):
                if frame_index < len(self.arrivals):
                    self.arrivals[frame_index] = now
                self.received += 1
                dst = self.keep.get(frame_index)
                if dst is not None:
                    torch.from_numpy(dst).copy_(
                        torch.from_numpy(np.asarray(host_frame)))
                    self.kept.add(frame_index)

    _CLASS = reg(BenchSink)
    return _CLASS
