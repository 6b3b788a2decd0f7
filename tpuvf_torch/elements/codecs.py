"""Host-side codec elements: pngenc, jpegenc, y4menc (port of
``tpuvf.elements.codecs``).

The reference test suite generates fixtures with
``videotestsrc ! pngenc ! filesink`` (tests/test-overlay.sh:27-31).  Encoders
run on the host at the pipeline edge: the graph treats them as passthrough
device-side and the frame loop applies `encode` before the sink consumes.
"""

from __future__ import annotations

import numpy as np

from tpuvf_torch.core.element import Element
from tpuvf_torch.core.formats import RGB_FORMATS, VideoFormat
from tpuvf_torch.core.properties import PropertyDescriptor
from tpuvf_torch.core.registry import register
from tpuvf_torch.core.spec import FrameSpec
from tpuvf_torch.io import png


class HostCodec(Element):
    """Marker base: encodes host frames to bytes at the sink edge."""

    HOST_CODEC = True

    def encode(self, host_frame, spec: FrameSpec) -> bytes:
        raise NotImplementedError


@register
class PngEnc(HostCodec):
    ELEMENT_NAME = "pngenc"
    DESCRIPTION = "PNG encoder"
    IN_FORMATS = RGB_FORMATS
    OUT_FORMATS = ()
    PROPERTIES = (
        PropertyDescriptor("compression-level", "int", 6, "zlib level", 0, 9),
    )

    def transform_spec(self, in_spec, out_filter=None):
        if not self.accepts_format(in_spec.format):
            raise ValueError(
                f"pngenc accepts RGB formats only, got {in_spec.format}")
        return in_spec

    def encode(self, host_frame, spec: FrameSpec) -> bytes:
        arr = np.asarray(host_frame)
        if spec.format == VideoFormat.BGRA:
            arr = arr[..., [2, 1, 0, 3]]
        return png.encode(arr)


@register
class JpegEnc(HostCodec):
    """Baseline JFIF encoder (jpegenc analog): RGB frames -> 4:2:0 JPEG
    via the native encoder (tpuvf_torch/native/jpegenc.cc — Annex-K tables,
    IJG quality scaling).  Pairs with the overlay's decoder; use
    multifilesink location=frame%05d.jpg for per-frame files."""

    ELEMENT_NAME = "jpegenc"
    DESCRIPTION = "JPEG encoder"
    IN_FORMATS = RGB_FORMATS
    OUT_FORMATS = ()
    PROPERTIES = (
        PropertyDescriptor("quality", "int", 85, "JPEG quality", 1, 100),
    )

    def transform_spec(self, in_spec, out_filter=None):
        if not self.accepts_format(in_spec.format):
            raise ValueError(
                f"jpegenc accepts RGB formats only, got {in_spec.format} "
                f"(insert vfconvertscale upstream)")
        from tpuvf_torch import native

        try:
            native.load()
        except Exception as exc:  # the compiler's output stays the cause
            raise ValueError(
                f"jpegenc needs the native JPEG library: {exc}") from exc
        return in_spec

    def encode(self, host_frame, spec: FrameSpec) -> bytes:
        from tpuvf_torch.native import jpeg as njpeg

        arr = np.asarray(host_frame)
        if spec.format == VideoFormat.BGRA:
            arr = arr[..., [2, 1, 0, 3]]
        return njpeg.encode(arr, self.props.get("quality"))


@register
class Y4MEnc(HostCodec):
    """YUV4MPEG2 encoder (`y4menc` analog): accepts I420 and prepends the
    stream header (geometry, frame rate, aspect, interlacing from the
    negotiated spec) to the first frame, so
    `... ! y4menc ! filesink location=out.y4m` produces a playable
    stream that y4msrc (or any y4mdec) reads back bit-exactly."""

    ELEMENT_NAME = "y4menc"
    DESCRIPTION = "YUV4MPEG2 (.y4m) encoder"
    IN_FORMATS = (VideoFormat.I420,)
    OUT_FORMATS = ()

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self._wrote_header = False

    def transform_spec(self, in_spec, out_filter=None):
        if in_spec.format != VideoFormat.I420:
            raise ValueError(
                f"y4menc accepts I420 only, got {in_spec.format} "
                f"(insert vfconvertscale upstream)")
        from tpuvf_torch.io import y4m

        # validate dimensions at negotiate time, not first frame; a
        # (re)negotiate also restarts the stream, so the next encode
        # writes a fresh header (filesink reopens its file at prepare)
        y4m.stream_header(in_spec.width, in_spec.height)
        self._wrote_header = False
        return in_spec

    def encode(self, host_frame, spec: FrameSpec) -> bytes:
        from tpuvf_torch.io import y4m

        out = y4m.encode_frame(host_frame)
        if not self._wrote_header:
            self._wrote_header = True
            interlacing = ("p" if not spec.interlaced
                           else ("t" if spec.tff else "b"))
            out = y4m.stream_header(
                spec.width, spec.height,
                fps=(spec.fps.num, spec.fps.den),
                par=(spec.par.num, spec.par.den),
                interlacing=interlacing) + out
        return out
