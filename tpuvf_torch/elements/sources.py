"""Additional sources (port of ``tpuvf.elements.sources``): appsrc
(programmatic frames), rawvideosrc (raw .yuv/.rgba file reader) and y4msrc
(YUV4MPEG2 streams) — how real footage enters the framework in place of
GStreamer's filesrc/decodebin front ends."""

from __future__ import annotations

import os

import numpy as np

from tpuvf_torch.core.element import SourceElement
from tpuvf_torch.core.formats import ALL_FORMATS, VideoFormat, chroma_dims_420
from tpuvf_torch.core.properties import PropertyDescriptor
from tpuvf_torch.core.registry import register
from tpuvf_torch.core.spec import CapsFilter, Fraction, FrameSpec


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


@register
class RawVideoSrc(SourceElement):
    """Reads raw frames from a file (the filesrc ! rawvideoparse analog).

    Frame layout matches filesink's output: interleaved bytes for RGB and
    packed formats; Y then UV (NV12) or Y, U, V (I420) planes.
    """

    ELEMENT_NAME = "rawvideosrc"
    ALIASES = ("rawsrc",)
    DESCRIPTION = "Reads raw video frames from a file"
    OUT_FORMATS = ALL_FORMATS
    PROPERTIES = (
        PropertyDescriptor("location", "string", None, "Raw video file"),
        PropertyDescriptor("format", "string", "I420", "Video format"),
        PropertyDescriptor("width", "int", 320, "Frame width", 1, 2**31 - 1),
        PropertyDescriptor("height", "int", 240, "Frame height", 1, 2**31 - 1),
        PropertyDescriptor("num-buffers", "int", -1,
                           "Max frames (-1 = whole file)", -1, 2**31 - 1),
    )

    def _geometry(self, spec: FrameSpec):
        w, h = spec.width, spec.height
        fmt = spec.format
        if fmt in (VideoFormat.BGRA, VideoFormat.RGBA):
            return ("interleaved", h * w * 4)
        if fmt in (VideoFormat.UYVY, VideoFormat.YUY2):
            return ("packed", h * w * 2)
        cw, ch = chroma_dims_420(w, h)
        return ("planar420", h * w + 2 * ch * cw)

    def output_spec(self, out_filter: CapsFilter | None) -> FrameSpec:
        spec = FrameSpec(
            VideoFormat(self.props.get("format").upper()),
            self.props.get("width"), self.props.get("height"),
        )
        if out_filter is not None:
            spec = out_filter.apply(spec)
        return spec

    def num_frames(self):
        loc = self.props.get("location")
        if not loc or not os.path.exists(loc):
            return 0
        spec = self.output_spec(None)
        _, frame_bytes = self._geometry(spec)
        total = os.path.getsize(loc) // frame_bytes
        limit = self.props.get("num-buffers")
        return total if limit < 0 else min(total, limit)

    def generate(self, frame_index: int, spec: FrameSpec):
        loc = self.props.get("location")
        kind, frame_bytes = self._geometry(spec)
        with open(loc, "rb") as fh:
            fh.seek(frame_index * frame_bytes)
            raw = np.frombuffer(fh.read(frame_bytes), np.uint8)
        w, h = spec.width, spec.height
        if kind == "interleaved":
            return raw.reshape(h, w, 4).copy()
        if kind == "packed":
            return raw.reshape(h, 2 * w).copy()
        cw, ch = chroma_dims_420(w, h)
        y = raw[: h * w].reshape(h, w).copy()
        rest = raw[h * w:]
        if spec.format == VideoFormat.NV12:
            return {"y": y, "uv": rest.reshape(ch, 2 * cw).copy()}
        u = rest[: ch * cw].reshape(ch, cw).copy()
        v = rest[ch * cw:].reshape(ch, cw).copy()
        return {"y": y, "u": u, "v": v}


@register
class Y4MSrc(SourceElement):
    """Reads YUV4MPEG2 streams (the `filesrc ! y4mdec` analog): geometry,
    frame rate, pixel aspect and interlacing come from the stream header,
    so no caps are needed.  C420* maps to I420, C422 to UYVY macro-pixels,
    Cmono to I420 with flat chroma (tpuvf_torch.io.y4m)."""

    ELEMENT_NAME = "y4msrc"
    ALIASES = ("y4mdec",)
    DESCRIPTION = "Reads frames from a YUV4MPEG2 (.y4m) stream"
    OUT_FORMATS = (VideoFormat.I420, VideoFormat.UYVY)
    PROPERTIES = (
        PropertyDescriptor("location", "string", None, "Y4M file path"),
        PropertyDescriptor("num-buffers", "int", -1,
                           "Max frames (-1 = whole file)", -1, 2**31 - 1),
    )

    def _reader(self):
        from tpuvf_torch.io import y4m

        loc = self.props.get("location")
        if not loc:
            raise ValueError("y4msrc requires location=")
        if not os.path.exists(loc):
            raise ValueError(f"y4msrc: no such file {loc!r}")
        st = os.stat(loc)
        key = (loc, st.st_mtime_ns, st.st_size)
        if getattr(self, "_y4m_key", None) != key:
            # key includes mtime+size: rewriting the file at the same
            # path between runs must not reuse stale header/offsets
            self._y4m_reader = y4m.Reader(loc)
            self._y4m_key = key
        return self._y4m_reader

    def output_spec(self, out_filter: CapsFilter | None) -> FrameSpec:
        hdr = self._reader().header
        fmt = (VideoFormat.UYVY if hdr["colorspace"] == "422"
               else VideoFormat.I420)
        spec = FrameSpec(
            fmt, hdr["width"], hdr["height"],
            fps=Fraction(*hdr["fps"]), par=Fraction(*hdr["par"]),
            interlaced=hdr["interlacing"] in ("t", "b"),
            tff=hdr["interlacing"] != "b",
        )
        if out_filter is not None:
            filtered = out_filter.apply(spec)
            # geometry and format come from the stream; caps that
            # contradict the header must fail at negotiate (GStreamer's
            # not-negotiated), not deliver header-shaped frames under a
            # lying spec
            for field in ("format", "width", "height"):
                got = getattr(filtered, field)
                want = getattr(spec, field)
                if got != want:
                    raise ValueError(
                        f"y4msrc: caps {field}={got} contradicts the "
                        f"stream header ({field}={want})")
            spec = filtered
        return spec

    def num_frames(self):
        total = self._reader().num_frames()
        limit = self.props.get("num-buffers")
        return total if limit < 0 else min(total, limit)

    def generate(self, frame_index: int, spec: FrameSpec):
        return self._reader().read_frame(frame_index)
