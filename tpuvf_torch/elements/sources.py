"""appsrc — frames pushed from Python (port of ``tpuvf.elements.sources``
AppSrc; rawvideosrc and y4msrc are not ported yet)."""

from __future__ import annotations

from tpuvf_torch.core.element import SourceElement
from tpuvf_torch.core.formats import ALL_FORMATS, VideoFormat
from tpuvf_torch.core.properties import PropertyDescriptor
from tpuvf_torch.core.registry import register
from tpuvf_torch.core.spec import CapsFilter, FrameSpec


@register
class AppSrc(SourceElement):
    """Frames pushed from Python: `elem.push(host_frame)`; end with
    `end_of_stream()`.  Host frames use the native layout for the negotiated
    format (see tpuvf_torch.core.frame)."""

    ELEMENT_NAME = "appsrc"
    DESCRIPTION = "Accepts frames pushed from application code"
    OUT_FORMATS = ALL_FORMATS
    PROPERTIES = (
        PropertyDescriptor("format", "string", "RGBA", "Video format"),
        PropertyDescriptor("width", "int", 320, "Frame width", 1, 2**31 - 1),
        PropertyDescriptor("height", "int", 240, "Frame height", 1, 2**31 - 1),
    )

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self._queue: list = []
        self._meta: list = []
        self._eos = False

    def push(self, host_frame, pts: float | None = None,
             tff: bool | None = None) -> None:
        """Queue a frame; optional per-buffer pts (seconds) and TFF flag
        (the GstBuffer pts / GST_VIDEO_BUFFER_FLAG_TFF analog)."""
        self._queue.append(host_frame)
        self._meta.append({"pts": pts, "tff": tff})

    def end_of_stream(self) -> None:
        self._eos = True

    def buffer_pts(self, frame_index: int, spec: FrameSpec) -> float:
        if frame_index < len(self._meta):
            pts = self._meta[frame_index].get("pts")
            if pts is not None:
                return float(pts)
        return super().buffer_pts(frame_index, spec)

    def buffer_meta(self, frame_index: int, spec: FrameSpec):
        meta = super().buffer_meta(frame_index, spec)
        if frame_index < len(self._meta):
            tff = self._meta[frame_index].get("tff")
            if tff is not None:
                meta["tff"] = bool(tff)
        return meta

    def output_spec(self, out_filter: CapsFilter | None) -> FrameSpec:
        spec = FrameSpec(
            VideoFormat(self.props.get("format").upper()),
            self.props.get("width"), self.props.get("height"),
        )
        if out_filter is not None:
            spec = out_filter.apply(spec)
        return spec

    def num_frames(self):
        return len(self._queue) if self._eos or self._queue else None

    def generate(self, frame_index: int, spec: FrameSpec):
        if frame_index >= len(self._queue):
            raise IndexError("appsrc queue exhausted")
        return self._queue[frame_index]
