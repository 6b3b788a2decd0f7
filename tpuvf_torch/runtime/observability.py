"""Tracing, metrics and failure handling (port of
``tpuvf.runtime.observability``).

- ``TPUVF_DEBUG`` configures per-category log levels with GST_DEBUG's
  syntax ("3", "pipeline:5,*:2"); categories live under the ``tpuvf_torch``
  logger.
- ``PipelineStats`` counts frames and wall time per pipeline, the build
  time (the first-use kernel build included), the ticks a live run dropped
  and, for the port's run loops, the host time of each part of the frame
  edge (``edge_seconds``), the frames uploaded straight from a source's
  memory or through a host copy (``upload_direct``, ``upload_filled``),
  the bytes of them that no draw reads and no copy moved
  (``upload_culled``), the frames read back on a readback stream of
  their own (``readback_async``) and the events recorded there for their
  delivery (``readback_events``, one a chunk of a batch's copies).
- ``trace()`` is the one span: it reads the host clock at each end and
  adds the difference to its part of ``edge_seconds``
  (``tpuvf_torch.upload`` -> ``"upload"``).  Only while a torch profiler
  is active does it also open ``torch.profiler.record_function`` over the
  same interval, the frame or batch index in its ``args``, so the spans
  share the profiler's clock with the card's kernels and copies; with none
  active a span costs two clock reads and a dict add.  Span names carry no
  index.  ``TPUVF_DEBUG=perf:5`` logs each span's milliseconds, and at the
  end of each run the edge parts' seconds, the upload counts, the culled
  bytes, ``readback_async`` and ``readback_events``.
- ``profiler_trace(path)`` captures the enclosed region with torch.profiler
  (the host, and the CUDA activity on a GPU) as a Chrome trace at `path`.
- Per-frame failures surface as ``PipelineError`` (the GST_FLOW_ERROR
  analog) naming the failing element and the frame.
"""

from __future__ import annotations

import logging
import os
from contextlib import contextmanager
from dataclasses import dataclass, field
from time import perf_counter
from typing import Dict, Optional

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


# the parts of a frame's host edge in the run loops, in order: each but
# "step" is the seconds of the span "tpuvf_torch.<part>"; "step" is
# params + enqueue (params.select and params.tables nest inside params)
EDGE_PARTS = ("params", "params.select", "params.tables", "upload",
              "upload.source", "upload.alloc", "upload.fill", "upload.copy",
              "enqueue", "step", "readback", "wait", "consume")
_PREFIX = "tpuvf_torch."
# span name -> its edge_seconds key
_EDGE_KEY = {_PREFIX + k: k for k in EDGE_PARTS if k != "step"}


@dataclass
class PipelineStats:
    frames: int = 0
    wall_seconds: float = 0.0
    compile_seconds: float = 0.0
    # run_live: output clock ticks skipped because the pipeline was still
    # busy at their deadline (QoS frame dropping)
    frames_dropped: int = 0
    per_element_active: Dict[str, bool] = field(default_factory=dict)
    # frames a source that the run loops' uploads copied to the card
    # straight from the source's registered memory, and through a host copy
    # (``core.frame.HostRegistry``); their hit share is direct / (direct +
    # filled)
    upload_direct: int = 0
    upload_filled: int = 0
    # bytes of the frames copied straight that their regions left out: the
    # pixels no draw of their compositor's table reads
    # (``CompiledStep.upload_rows``)
    upload_culled: int = 0
    # frames the loops read back on the compiled step's readback stream
    # (CUDA, no mesh), beside the next batch's step
    readback_async: int = 0
    # the events recorded after those frames' copies, each waited on once
    # (``Pipeline._readback_batch``: one a chunk of a batch's copies)
    readback_events: int = 0
    # host seconds of each part of the run loops' frame edge (EDGE_PARTS),
    # each the summed durations of its span (`trace`): params (controllers
    # synced, buffers selected, params read and staged) with its parts
    # params.select (each frame's `_select_buffers`) and params.tables
    # (each frame's `_frame_tables`, the compositors' prepare pass; 0
    # without a compositor), upload (all of a
    # frame's or a batch's upload) with its parts upload.source (the
    # source's generate), upload.alloc (the fresh pinned host buffer, or the
    # registration of a source's memory), upload.fill (the host copy into
    # it) and upload.copy (the non-blocking copies' enqueue, straight from
    # a source's registered memory or from the pinned buffer), enqueue (the
    # step's replay or eager run), readback (the copies to the host and the
    # events, enqueued: a call and an event a chunk of a batch's frames),
    # wait (on a readback's event, once a chunk), consume (codecs and the
    # sinks, a frame each); step = params + enqueue
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


_perf = logging.getLogger("tpuvf_torch.perf")
_profiling = torch._C._autograd._profiler_enabled


class trace:
    """A span over the `with` block: `name` (``tpuvf_torch.<part>``, no
    index in it); with `edge` (a `PipelineStats.edge_seconds`) its host
    seconds add to the part's key, and those of ``params`` and ``enqueue``
    to ``step`` too.  While a torch profiler is active the same interval is
    a ``torch.profiler.record_function`` range whose ``args`` is
    ``str(args)`` (the frame or batch index, with the shard on a mesh);
    formatted only then."""

    __slots__ = ("name", "edge", "args", "_t0", "_range")

    def __init__(self, name: str, edge: Optional[Dict[str, float]] = None,
                 args=None):
        self.name = name
        self.edge = edge
        self.args = args

    def __enter__(self):
        if _profiling():
            self._range = torch.profiler.record_function(
                self.name, None if self.args is None else str(self.args))
            self._range.__enter__()
        else:
            self._range = None
        self._t0 = perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
        edge = self.edge
        if edge is not None:
            key = _EDGE_KEY[self.name]
            edge[key] += dt
            if key == "params" or key == "enqueue":
                edge["step"] += dt
        if _perf.isEnabledFor(logging.DEBUG):
            _perf.debug("%s: %.3f ms", self.name, dt * 1e3)
        return False


@contextmanager
def profiler_trace(path: str):
    """Capture the enclosed region with torch.profiler, the host and, on a
    GPU, the CUDA activity, and write it as a Chrome trace at `path`
    (chrome://tracing, Perfetto): the ``tpuvf_torch.*`` spans beside the
    card's kernels and copies, on one clock (the torch twin of tpuvf's
    xprof ``profiler_trace``).  Yields the profiler.  Raises before the
    capture when `path`'s directory does not exist (torch's export would
    only log it)."""
    from torch.profiler import ProfilerActivity, profile

    folder = os.path.dirname(os.path.abspath(path))
    if not os.path.isdir(folder):
        raise FileNotFoundError(f"profiler_trace: no directory {folder!r}")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(path)
