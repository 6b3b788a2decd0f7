"""videotestsrc analog — procedural test patterns (port of
``tpuvf.elements.testsrc``).

Mirrors the videotestsrc patterns exercised by the reference test suites
(smpte, snow, ball, red — plus solid colors).  Patterns are generated as
host RGBA and converted to the negotiated format with the same BT.601/709
math as the device kernels.  Packed 4:2:2 output is produced here but cannot
enter a pipeline yet (core.frame).
"""

from __future__ import annotations

import numpy as np

from tpuvf_torch.core.element import SourceElement
from tpuvf_torch.core.formats import ALL_FORMATS, VideoFormat, chroma_dims_420
from tpuvf_torch.core.properties import PropertyDescriptor
from tpuvf_torch.core.registry import register
from tpuvf_torch.core.spec import CapsFilter, FrameSpec
from tpuvf_torch.kernels.color import RGB_TO_YUV, YUV_OFFSET

PATTERNS = (
    ("smpte", 0),
    ("snow", 1),
    ("black", 2),
    ("white", 3),
    ("red", 4),
    ("green", 5),
    ("blue", 6),
    ("ball", 18),
)
_PATTERN_BY_VALUE = {v: n for n, v in PATTERNS}

# 75%-amplitude SMPTE color bars (top section), full-amplitude pluge row
_BAR_COLORS = np.array(
    [
        [191, 191, 191], [191, 191, 0], [0, 191, 191], [0, 191, 0],
        [191, 0, 191], [191, 0, 0], [0, 0, 191],
    ],
    np.uint8,
)
_CASTELLATION = np.array(
    [[0, 0, 191], [19, 19, 19], [191, 0, 191], [19, 19, 19],
     [0, 191, 191], [19, 19, 19], [191, 191, 191]],
    np.uint8,
)


def _smpte_rgba(w: int, h: int) -> np.ndarray:
    img = np.zeros((h, w, 4), np.uint8)
    img[..., 3] = 255
    top = (h * 2) // 3
    mid = (h * 3) // 4
    xs = np.arange(w)
    bar = np.minimum(xs * 7 // max(w, 1), 6)
    img[:top, :, :3] = _BAR_COLORS[bar]
    img[top:mid, :, :3] = _CASTELLATION[bar]
    # bottom quarter: -I / white / +Q / black+pluge blocks
    blocks = np.array(
        [[0, 33, 76], [255, 255, 255], [50, 0, 106], [19, 19, 19],
         [9, 9, 9], [19, 19, 19], [29, 29, 29], [19, 19, 19]],
        np.uint8,
    )
    blk = np.minimum(xs * 8 // max(w, 1), 7)
    img[mid:, :, :3] = blocks[blk]
    return img


def _solid_rgba(w: int, h: int, rgb) -> np.ndarray:
    img = np.empty((h, w, 4), np.uint8)
    img[..., 0], img[..., 1], img[..., 2] = rgb
    img[..., 3] = 255
    return img


def _snow_rgba(w: int, h: int, frame: int) -> np.ndarray:
    rng = np.random.default_rng(0xC0FFEE + frame)
    gray = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
    return np.concatenate(
        [gray, gray, gray, np.full((h, w, 1), 255, np.uint8)], axis=-1
    )


def _ball_rgba(w: int, h: int, frame: int) -> np.ndarray:
    img = np.zeros((h, w, 4), np.uint8)
    img[..., 3] = 255
    t = frame * 0.1
    cx = w / 2.0 + (w / 3.0) * np.sin(t)
    cy = h / 2.0 + (h / 3.0) * np.cos(t * 0.7)
    radius = max(2.0, h / 10.0)
    ys, xs = np.mgrid[0:h, 0:w]
    d2 = (xs - cx) ** 2 + (ys - cy) ** 2
    inside = d2 <= radius * radius
    # soft-ish edge like videotestsrc's antialiased ball
    img[..., 0] = np.where(inside, 255, 20)
    img[..., 1] = np.where(inside, 255, 20)
    img[..., 2] = np.where(inside, 255, 20)
    return img


def rgba_to_host(rgba: np.ndarray, spec: FrameSpec):
    """Host-side RGBA -> native layout for spec.format (numpy, same math as
    the device pack path: 2x2 box chroma average, matrices from color.py)."""
    fmt, w, h = spec.format, spec.width, spec.height
    if fmt == VideoFormat.RGBA:
        return rgba.copy()
    if fmt == VideoFormat.BGRA:
        return np.ascontiguousarray(rgba[..., [2, 1, 0, 3]])
    m = RGB_TO_YUV[spec.matrix_index]
    rgbf = rgba[..., :3].astype(np.float32) / np.float32(255.0)
    yuv = rgbf @ m.T + YUV_OFFSET

    def q(x):
        return np.round(np.clip(x, 0.0, 1.0) * 255.0).astype(np.uint8)

    yq = q(yuv[..., 0])
    if fmt in (VideoFormat.NV12, VideoFormat.I420):
        cw, ch = chroma_dims_420(w, h)
        pad_h, pad_w = 2 * ch - h, 2 * cw - w
        rp = np.pad(rgbf, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
        avg = rp.reshape(ch, 2, cw, 2, 3).mean(axis=(1, 3), dtype=np.float32)
        cyuv = avg @ m.T + YUV_OFFSET
        u, v = q(cyuv[..., 1]), q(cyuv[..., 2])
        if fmt == VideoFormat.I420:
            return {"y": yq, "u": u, "v": v}
        uv = np.empty((ch, 2 * cw), np.uint8)
        uv[:, 0::2] = u
        uv[:, 1::2] = v
        return {"y": yq, "uv": uv}
    if fmt in (VideoFormat.UYVY, VideoFormat.YUY2):
        cw = w // 2
        u = q((yuv[:, 0::2, 1] + yuv[:, 1::2, 1]) * 0.5)
        v = q((yuv[:, 0::2, 2] + yuv[:, 1::2, 2]) * 0.5)
        raw = np.empty((h, cw, 4), np.uint8)
        if fmt == VideoFormat.UYVY:
            raw[..., 0], raw[..., 1], raw[..., 2], raw[..., 3] = (
                u, yq[:, 0::2], v, yq[:, 1::2])
        else:
            raw[..., 0], raw[..., 1], raw[..., 2], raw[..., 3] = (
                yq[:, 0::2], u, yq[:, 1::2], v)
        return raw.reshape(h, 4 * cw)
    raise ValueError(fmt)


@register
class VideoTestSrc(SourceElement):
    ELEMENT_NAME = "videotestsrc"
    ALIASES = ("testsrc",)
    DESCRIPTION = "Procedural video test patterns"
    OUT_FORMATS = ALL_FORMATS
    PROPERTIES = (
        PropertyDescriptor("pattern", "enum", 0, "Test pattern",
                           enum_values=PATTERNS),
        PropertyDescriptor("num-buffers", "int", -1,
                           "Number of buffers to output (-1 = unlimited)",
                           minimum=-1, maximum=2**31 - 1),
        PropertyDescriptor("is-live", "bool", False, "Act as a live source"),
        PropertyDescriptor("timestamp-offset", "int", 0,
                           "Stream start time (nanoseconds)",
                           minimum=0, maximum=2**63 - 1),
    )

    DEFAULT_SPEC = FrameSpec(VideoFormat.I420, 320, 240)

    def output_spec(self, out_filter: CapsFilter | None) -> FrameSpec:
        spec = self.DEFAULT_SPEC
        if out_filter is not None:
            spec = out_filter.apply(spec)
        return spec

    def generate(self, frame_index: int, spec: FrameSpec):
        w, h = spec.width, spec.height
        pat = _PATTERN_BY_VALUE[self.props.get("pattern")]
        if pat == "smpte":
            rgba = self._cached_static(pat, w, h, _smpte_rgba)
        elif pat == "snow":
            rgba = _snow_rgba(w, h, frame_index)
        elif pat == "ball":
            rgba = _ball_rgba(w, h, frame_index)
        elif pat == "black":
            rgba = self._cached_static(pat, w, h, lambda w_, h_: _solid_rgba(w_, h_, (0, 0, 0)))
        elif pat == "white":
            rgba = self._cached_static(pat, w, h, lambda w_, h_: _solid_rgba(w_, h_, (255, 255, 255)))
        elif pat == "red":
            rgba = self._cached_static(pat, w, h, lambda w_, h_: _solid_rgba(w_, h_, (255, 0, 0)))
        elif pat == "green":
            rgba = self._cached_static(pat, w, h, lambda w_, h_: _solid_rgba(w_, h_, (0, 255, 0)))
        elif pat == "blue":
            rgba = self._cached_static(pat, w, h, lambda w_, h_: _solid_rgba(w_, h_, (0, 0, 255)))
        else:  # pragma: no cover
            raise ValueError(pat)
        return rgba_to_host(rgba, spec)

    def _cached_static(self, pat, w, h, fn):
        key = (pat, w, h)
        cache = getattr(self, "_pattern_cache", None)
        if cache is None:
            cache = self._pattern_cache = {}
        if key not in cache:
            cache[key] = fn(w, h)
        return cache[key]
