"""Video pixel formats and plane geometry.

Mirrors the format support of the vfmetal reference elements
(src/convertscale/gstvfmetalconvertscale.m:48 — BGRA, RGBA, NV12, I420,
UYVY, YUY2; other elements support the first four).  A copy of
``tpuvf.core.formats``: the JAX package cannot be imported without loading
jax, so the port carries its own framework-neutral modules.

On device every frame is stored as *canonical planes*:

- RGB formats (BGRA/RGBA): one ``rgba`` array of shape ``(4, H, W)`` uint8 in
  R,G,B,A channel order.  Host byte order (BGRA vs RGBA) only matters at the
  host<->device boundary.
- 4:2:0 YUV (NV12/I420): ``y (H, W)``, ``u (ch, cw)``, ``v (ch, cw)`` uint8
  with ``cw = ceil(W/2)``, ``ch = ceil(H/2)``.  NV12's interleaved UV plane is
  split at the edge (and re-interleaved on output).
- 4:2:2 packed (UYVY/YUY2): ``y (H, W)``, ``u (H, W//2)``, ``v (H, W//2)``.
  This planar decomposition reproduces the reference's macro-pixel nearest
  decode exactly (metalconvertscale_shaders.h:150-198): nearest-sampling the
  half-width chroma plane at a texcoord selects the same macro-pixel as the
  fragment's explicit floor(pixelX/2) computation.

W is deliberately the innermost (contiguous) axis: neighbouring CUDA threads
read neighbouring pixels, and the column resampler gathers along it.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class VideoFormat(str, enum.Enum):
    BGRA = "BGRA"
    RGBA = "RGBA"
    NV12 = "NV12"
    I420 = "I420"
    UYVY = "UYVY"
    YUY2 = "YUY2"

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.value


RGB_FORMATS = (VideoFormat.BGRA, VideoFormat.RGBA)
PLANAR_YUV_FORMATS = (VideoFormat.NV12, VideoFormat.I420)
PACKED_YUV_FORMATS = (VideoFormat.UYVY, VideoFormat.YUY2)
YUV_FORMATS = PLANAR_YUV_FORMATS + PACKED_YUV_FORMATS
ALL_FORMATS = RGB_FORMATS + PLANAR_YUV_FORMATS + PACKED_YUV_FORMATS

# The 4-format set supported by videofilter/transform/deinterlace/overlay/
# compositor (gstvfmetalvideofilter.m:53 etc.)
CORE_FORMATS = (VideoFormat.BGRA, VideoFormat.RGBA, VideoFormat.NV12, VideoFormat.I420)


def parse_format(name: str) -> VideoFormat:
    try:
        return VideoFormat(name.upper())
    except ValueError:
        raise ValueError(f"unsupported video format {name!r}") from None


def is_rgb(fmt: VideoFormat) -> bool:
    return fmt in RGB_FORMATS


def is_yuv(fmt: VideoFormat) -> bool:
    return fmt in YUV_FORMATS


def is_packed_yuv(fmt: VideoFormat) -> bool:
    return fmt in PACKED_YUV_FORMATS


def has_alpha(fmt: VideoFormat) -> bool:
    # Both BGRA and RGBA carry alpha; YUV formats do not.
    return fmt in RGB_FORMATS


def chroma_dims_420(width: int, height: int) -> tuple[int, int]:
    """(cw, ch) of 4:2:0 chroma planes, ceil-divided like GstVideoInfo."""
    return (width + 1) // 2, (height + 1) // 2


def chroma_dims_422(width: int, height: int) -> tuple[int, int]:
    """(cw, ch) of 4:2:2 packed chroma: half width (even W required), full H."""
    return width // 2, height


@dataclass(frozen=True)
class PlaneDef:
    """Geometry of one canonical device plane."""

    name: str
    width: int
    height: int
    channels: int = 1  # leading axis for 'rgba'


def canonical_planes(fmt: VideoFormat, width: int, height: int) -> tuple[PlaneDef, ...]:
    """Canonical device plane set for a format at the given frame size."""
    if fmt in RGB_FORMATS:
        return (PlaneDef("rgba", width, height, channels=4),)
    if fmt in PLANAR_YUV_FORMATS:
        cw, ch = chroma_dims_420(width, height)
        return (
            PlaneDef("y", width, height),
            PlaneDef("u", cw, ch),
            PlaneDef("v", cw, ch),
        )
    if fmt in PACKED_YUV_FORMATS:
        cw, ch = chroma_dims_422(width, height)
        return (
            PlaneDef("y", width, height),
            PlaneDef("u", cw, ch),
            PlaneDef("v", cw, ch),
        )
    raise ValueError(f"unknown format {fmt}")


def validate_dims(fmt: VideoFormat, width: int, height: int) -> None:
    if width < 1 or height < 1:
        raise ValueError(f"invalid frame size {width}x{height}")
    if fmt in PACKED_YUV_FORMATS and width % 2 != 0:
        raise ValueError(f"{fmt} requires even width, got {width}")
