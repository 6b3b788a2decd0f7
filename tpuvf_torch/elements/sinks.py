"""Sink elements: fakesink, appsink (frame capture), filesink (raw dump)
and multifilesink (a file a frame); port of ``tpuvf.elements.sinks``."""

from __future__ import annotations

import numpy as np

from tpuvf_torch.core.element import SinkElement
from tpuvf_torch.core.formats import VideoFormat
from tpuvf_torch.core.properties import PropertyDescriptor
from tpuvf_torch.core.registry import register
from tpuvf_torch.core.spec import FrameSpec


def _write_frame(fh, host_frame, spec) -> None:
    """Raw-video byte layout shared by filesink and multifilesink:
    encoder bytes pass through; plane dicts follow the GStreamer raw
    order (NV12: Y, UV; I420: Y, U, V); arrays dump directly."""
    if isinstance(host_frame, (bytes, bytearray)):
        fh.write(host_frame)
        return
    if isinstance(host_frame, dict):
        fmt = spec.format
        if fmt == VideoFormat.NV12:
            order = ("y", "uv")
        elif fmt == VideoFormat.I420:
            order = ("y", "u", "v")
        else:
            order = tuple(sorted(host_frame))
        for k in order:
            fh.write(np.ascontiguousarray(host_frame[k]).data)
        return
    fh.write(np.ascontiguousarray(host_frame).data)  # the array's own bytes


@register
class FakeSink(SinkElement):
    """Discards frames (the fakesink used by every reference smoke test)."""

    KEEPS_PAYLOAD = False
    ELEMENT_NAME = "fakesink"
    DESCRIPTION = "Discards all frames"
    PROPERTIES = (
        PropertyDescriptor("sync", "bool", False, "Sync on the clock"),
        PropertyDescriptor("silent", "bool", True, "Don't emit notifications"),
    )

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.frame_count = 0

    def consume(self, host_frame, spec, frame_index):
        self.frame_count += 1


@register
class AppSink(SinkElement):
    """Collects host frames for inspection from Python (appsink analog)."""

    ELEMENT_NAME = "appsink"
    DESCRIPTION = "Collects frames into memory"
    PROPERTIES = (
        PropertyDescriptor("max-buffers", "int", 0, "Keep at most N frames "
                           "(0 = all)", minimum=0, maximum=2**31 - 1),
    )

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.frames: list = []
        self.spec: FrameSpec | None = None

    def prepare(self, in_spec):
        self.spec = in_spec

    def consume(self, host_frame, spec, frame_index):
        self.spec = spec
        limit = self.props.get("max-buffers")
        self.frames.append(host_frame)
        if limit and len(self.frames) > limit:
            self.frames.pop(0)


@register
class FileSink(SinkElement):
    """Appends raw frame bytes to a file (video/x-raw filesink analog).

    Plane order follows GStreamer raw video layout: interleaved formats dump
    their bytes directly; NV12 dumps Y then UV; I420 dumps Y, U, V.
    """

    KEEPS_PAYLOAD = False
    ELEMENT_NAME = "filesink"
    DESCRIPTION = "Writes raw frames to a file"
    PROPERTIES = (
        PropertyDescriptor("location", "string", None, "File path"),
        PropertyDescriptor("sync", "bool", False, "Sync on the clock"),
    )

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self._fh = None

    def prepare(self, in_spec):
        loc = self.props.get("location")
        if not loc:
            raise ValueError("filesink requires location=")
        self._fh = open(loc, "wb")

    def consume(self, host_frame, spec, frame_index):
        _write_frame(self._fh, host_frame, spec)

    def finalize(self):
        if self._fh:
            self._fh.close()
            self._fh = None


@register
class MultiFileSink(SinkElement):
    """Writes each frame to its own file (multifilesink analog):
    `location` is a printf-style pattern, e.g. frame%05d.png — the
    natural sink for per-frame encoders (pngenc, jpegenc)."""

    KEEPS_PAYLOAD = False
    ELEMENT_NAME = "multifilesink"
    DESCRIPTION = "Writes each frame to a separate file"
    PROPERTIES = (
        PropertyDescriptor("location", "string", None,
                           "File pattern with a frame-index directive, "
                           "e.g. frame%05d.png"),
        PropertyDescriptor("index", "int", 0, "First frame index",
                           0, 2**31 - 1),
    )

    def prepare(self, in_spec):
        loc = self.props.get("location")
        if not loc:
            raise ValueError("multifilesink requires location=")
        try:
            first = loc % self.props.get("index")
        except TypeError:
            raise ValueError(
                f"multifilesink location needs a %d-style index "
                f"directive, got {loc!r}")
        if first == loc % (self.props.get("index") + 1):
            raise ValueError(
                f"multifilesink location pattern {loc!r} does not vary "
                f"with the frame index")
        self.paths: list = []

    def consume(self, host_frame, spec, frame_index):
        path = self.props.get("location") % (
            self.props.get("index") + frame_index)
        with open(path, "wb") as fh:
            _write_frame(fh, host_frame, spec)
        self.paths.append(path)
