"""Tracing, metrics and failure handling (port of
``tpuvf.runtime.observability``).

- ``TPUVF_DEBUG`` configures per-category log levels with GST_DEBUG's
  syntax ("3", "pipeline:5,*:2"); categories live under the ``tpuvf_torch``
  logger.
- ``PipelineStats`` counts frames and wall time per pipeline, the build
  time (the first-use kernel build included), the ticks a live run dropped
  and, for the port's run loops, the host time of each part of the frame
  edge.
- ``trace()`` wraps a region in ``torch.profiler.record_function`` (a span
  in a torch.profiler trace) and logs its host-clock time at debug level.
- Per-frame failures surface as ``PipelineError`` (the GST_FLOW_ERROR
  analog) naming the failing element and the frame.
"""

from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict

import torch

_LEVELS = {
    "0": logging.CRITICAL,  # none
    "1": logging.ERROR,
    "2": logging.WARNING,
    "3": logging.INFO,  # FIXME/INFO
    "4": logging.INFO,
    "5": logging.DEBUG,
    "6": logging.DEBUG,  # LOG/TRACE
    "7": logging.DEBUG,
    "9": logging.DEBUG,
}

_configured = False


def configure_from_env() -> None:
    """Parse TPUVF_DEBUG like GST_DEBUG: 'LEVEL' or 'cat:LEVEL,cat2:LEVEL'."""
    global _configured
    if _configured:
        return
    _configured = True
    spec = os.environ.get("TPUVF_DEBUG", "")
    if not spec:
        return
    logging.basicConfig(
        format="%(asctime)s %(levelname).1s %(name)s %(message)s")
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            cat, level = part.rsplit(":", 1)
        else:
            cat, level = "*", part
        pylevel = _LEVELS.get(level.strip(), logging.DEBUG)
        name = ("tpuvf_torch" if cat in ("*", "")
                else f"tpuvf_torch.{cat.strip()}")
        logging.getLogger(name).setLevel(pylevel)


def get_logger(category: str) -> logging.Logger:
    configure_from_env()
    return logging.getLogger(f"tpuvf_torch.{category}")


class PipelineError(RuntimeError):
    """Per-frame processing failure (the GST_FLOW_ERROR analog)."""

    def __init__(self, element: str, frame_index: int, cause: Exception):
        super().__init__(
            f"element {element!r} failed at frame {frame_index}: {cause}")
        self.element = element
        self.frame_index = frame_index
        self.cause = cause


# the parts of a frame's host edge in Pipeline.run, in order
EDGE_PARTS = ("upload", "step", "readback", "wait", "consume")


@dataclass
class PipelineStats:
    frames: int = 0
    wall_seconds: float = 0.0
    compile_seconds: float = 0.0
    # run_live: output clock ticks skipped because the pipeline was still
    # busy at their deadline (QoS frame dropping)
    frames_dropped: int = 0
    per_element_active: Dict[str, bool] = field(default_factory=dict)
    # host seconds of each part of Pipeline.run's frames (EDGE_PARTS):
    # upload (host copy + enqueued copy to the device), step (enqueue),
    # readback (the host-layout permutation and the copies to the host,
    # enqueued), wait (on the previous frame's event), consume (the copy
    # for a sink that keeps its frames, codecs and sinks)
    edge_seconds: Dict[str, float] = field(
        default_factory=lambda: dict.fromkeys(EDGE_PARTS, 0.0))

    @property
    def fps(self) -> float:
        return self.frames / self.wall_seconds if self.wall_seconds else 0.0

    def summary(self) -> str:
        elided = [n for n, a in self.per_element_active.items() if not a]
        parts = [
            f"{self.frames} frames in {self.wall_seconds:.3f}s "
            f"({self.fps:.1f} fps)",
            f"compile {self.compile_seconds:.2f}s",
        ]
        if self.frames_dropped:
            parts.append(f"dropped {self.frames_dropped} (live QoS)")
        if elided:
            parts.append(f"passthrough-elided: {', '.join(elided)}")
        return "; ".join(parts)


@contextmanager
def trace(label: str):
    """torch.profiler span + host-clock timing; usable without a profiler."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(label):
        yield
    get_logger("perf").debug("%s: %.3f ms", label,
                             (time.perf_counter() - t0) * 1e3)
