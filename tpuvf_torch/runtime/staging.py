"""Per-frame parameters on the device (the port of tpuvf's ``_stage_params``
and ``_frame_params``, ``tpuvf/runtime/pipeline.py:713-742``).

Each frame the pipeline re-reads every active element's traced values
(`Element.traced_values`): the scalars the step reads on the device, and
values handed over as they are (a LUT table already on the device, the
compositor's host numbers).  tpuvf re-reads the scalars every frame and
keeps the staged copy of an array while the element hands over the same
object; the port does the same: it compares the scalars by value and
stages them again only when one changed.

A staged frame's scalars lie in one float32 device vector, and each
parameter is a 0-dim view of it.  On a GPU the values go through a pinned
host buffer and one non-blocking copy, so staging never waits for the
frames already queued (a ``torch.tensor(v, device="cuda")`` per scalar is
a pageable, blocking copy each).  The pinned buffers are taken in turns,
and a buffer is written again only after the copy that read it has run
(an event recorded behind the copy).  A staged vector is never written in
place: a changed frame gets a new one, so a queued step keeps reading its
own values.

The compositor's draw tables (int32, ``kernels/composite.py``) travel the
same way (`table`), through pinned buffers of their own.  The compiled
step (`runtime/compiled.py`) stages a frame's or a batch's scalars and
tables into its fixed device rows instead (`put` into them): those are
written in place, in stream order, behind the replays that read them
before.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# {element name: (scalars {key: float}, other values {key: value})}
Reads = Dict[str, Tuple[Dict[str, float], Dict]]


def read_params(elements, device) -> Reads:
    """Every element's traced values for this frame, read on the host."""
    return {e.name: e.traced_values(device) for e in elements}


class ParamStager:
    """Stages the scalars of `read_params` on one device."""

    SLOTS = 2  # pinned buffers a dtype, taken in turns

    def __init__(self, device: torch.device):
        self.device = device
        # dtype -> (turn, [[pinned buffer, event or None]])
        self._rings: Dict[torch.dtype, list] = {}
        self._last = None  # (keys, values) of the last staged frame
        self._views: List[torch.Tensor] = []

    @staticmethod
    def _layout(reads: Reads):
        keys = tuple((n, k) for n, (scalars, _) in reads.items()
                     for k in scalars)
        values = tuple(v for _, (scalars, _) in reads.items()
                       for v in scalars.values())
        return keys, values

    @staticmethod
    def _assemble(reads: Reads, views) -> Dict[str, Dict]:
        params, it = {}, iter(views)
        for name, (scalars, other) in reads.items():
            p = {k: next(it) for k in scalars}
            p.update(other)
            params[name] = p
        return params

    def frame(self, reads: Reads) -> Dict[str, Dict]:
        """One frame's params: the last staged scalars while none changed,
        else a freshly staged vector."""
        keys, values = self._layout(reads)
        if (keys, values) != self._last:
            self._views = list(self._stage([values])[0]) if values else []
            self._last = (keys, values)
        return self._assemble(reads, self._views)

    def table(self, table: np.ndarray) -> torch.Tensor:
        """A draw table (int32) -> a new tensor on the device."""
        return self.put(torch.from_numpy(table))

    def _stage(self, values: List[tuple]) -> torch.Tensor:
        """(n, k) host values -> a new (n, k) float32 tensor on the device."""
        return self.put(torch.tensor(values, dtype=torch.float32))

    def put(self, host: torch.Tensor, out: torch.Tensor | None = None):
        """Host tensor -> the device, into `out` (a device tensor of its
        shape and dtype) or a new tensor; -> that tensor.  On a GPU through
        a pinned buffer of the dtype's ring and one non-blocking copy."""
        if self.device.type != "cuda":
            if out is None:
                return host.to(self.device, copy=True)
            return out.copy_(host)
        ring = self._rings.setdefault(host.dtype, [0, []])
        slots = ring[1]
        if len(slots) < self.SLOTS:
            slots.append([None, None])
        slot = slots[ring[0] % len(slots)]
        ring[0] += 1
        if slot[1] is not None:
            slot[1].synchronize()  # the copy that read this buffer has run
        n = host.numel()
        if slot[0] is None or slot[0].numel() < n:
            slot[0] = torch.empty(n, dtype=host.dtype, pin_memory=True)
        pinned = slot[0][:n].view(host.shape)
        pinned.copy_(host)
        if out is None:
            out = pinned.to(self.device, non_blocking=True)
        else:
            out.copy_(pinned, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record()
        return out
