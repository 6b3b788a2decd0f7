"""FrameSpec — the static type of a video stream.

Replaces GStreamer caps (`video/x-raw,format=...,width=...`) with an explicit,
hashable spec that drives negotiation and plane geometry.  Semantics follow
GstVideoInfo: pixel-aspect-ratio and framerate are exact fractions; the color
matrix mirrors vf_metal_color_matrix_for_frame (reference
src/common/vfmetaltextureutil.m:25-41 — BT.709 if the caps say so, BT.601
otherwise).  A copy of ``tpuvf.core.spec``, which the port cannot import
without loading jax.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

from tpuvf_torch.core.formats import (
    VideoFormat,
    canonical_planes,
    parse_format,
    validate_dims,
)


@dataclass(frozen=True)
class Fraction:
    """Exact rational, always stored reduced with positive denominator.

    Ordering is by VALUE (num*other.den cross products) — a field-wise
    dataclass order would rank 3/2 above 2/1."""

    num: int
    den: int = 1

    def __lt__(self, other: "Fraction") -> bool:
        return self.num * other.den < other.num * self.den

    def __le__(self, other: "Fraction") -> bool:
        return self.num * other.den <= other.num * self.den

    def __gt__(self, other: "Fraction") -> bool:
        return other.__lt__(self)

    def __ge__(self, other: "Fraction") -> bool:
        return other.__le__(self)

    def __post_init__(self):
        if self.den == 0:
            raise ZeroDivisionError("fraction with zero denominator")
        g = math.gcd(self.num, self.den) or 1
        num, den = self.num // g, self.den // g
        if den < 0:
            num, den = -num, -den
        object.__setattr__(self, "num", num)
        object.__setattr__(self, "den", den)

    @classmethod
    def parse(cls, text: str) -> "Fraction":
        if "/" in text:
            n, d = text.split("/", 1)
            return cls(int(n), int(d))
        return cls(int(text), 1)

    def __mul__(self, other: "Fraction") -> "Fraction":
        return Fraction(self.num * other.num, self.den * other.den)

    def __truediv__(self, other: "Fraction") -> "Fraction":
        return Fraction(self.num * other.den, self.den * other.num)

    def __float__(self) -> float:
        return self.num / self.den

    def __str__(self) -> str:
        return f"{self.num}/{self.den}"


DEFAULT_FPS = Fraction(30, 1)
DEFAULT_PAR = Fraction(1, 1)


def default_matrix_for_size(width: int, height: int) -> str:
    """GStreamer convention: BT.709 for HD (height > 576), BT.601 for SD."""
    return "bt709" if height > 576 else "bt601"


@dataclass(frozen=True)
class FrameSpec:
    """Static description of a video stream (one negotiated caps set)."""

    format: VideoFormat
    width: int
    height: int
    fps: Fraction = DEFAULT_FPS
    par: Fraction = DEFAULT_PAR
    matrix: str = ""  # "bt601" | "bt709"; "" = derive from size
    interlaced: bool = False
    tff: bool = True  # top-field-first flag for interlaced content

    def __post_init__(self):
        validate_dims(self.format, self.width, self.height)
        if not self.matrix:
            object.__setattr__(
                self, "matrix", default_matrix_for_size(self.width, self.height)
            )
        if self.matrix not in ("bt601", "bt709"):
            raise ValueError(f"unknown color matrix {self.matrix!r}")

    # -- helpers -----------------------------------------------------------

    @property
    def matrix_index(self) -> int:
        """0=BT.601, 1=BT.709 (vfmetaltextureutil.m:25-41)."""
        return 1 if self.matrix == "bt709" else 0

    @property
    def planes(self):
        return canonical_planes(self.format, self.width, self.height)

    @property
    def dar(self) -> Fraction:
        """Display aspect ratio = (w/h) * par."""
        return Fraction(self.width, self.height) * self.par

    def with_(self, **kw) -> "FrameSpec":
        return replace(self, **kw)

    def __str__(self) -> str:
        return (
            f"video/x-raw,format={self.format.value},width={self.width},"
            f"height={self.height},framerate={self.fps},"
            f"pixel-aspect-ratio={self.par},matrix={self.matrix}"
        )


@dataclass(frozen=True)
class Range:
    """Inclusive value range (``width=[320,1280]``,
    ``framerate=[25/1,30/1]``) — the GST_TYPE_INT_RANGE /
    GST_TYPE_FRACTION_RANGE analog."""

    lo: object
    hi: object

    def __post_init__(self):
        if float(self.lo) > float(self.hi):
            raise ValueError(f"empty range [{self.lo},{self.hi}]")

    def contains(self, v) -> bool:
        return float(self.lo) <= float(v) <= float(self.hi)

    def nearest(self, target):
        """Clamp — gst_structure_fixate_field_nearest_int semantics."""
        if float(target) < float(self.lo):
            return self.lo
        if float(target) > float(self.hi):
            return self.hi
        return target

    def __str__(self) -> str:
        return f"[{self.lo},{self.hi}]"


@dataclass(frozen=True)
class ValueList:
    """Finite set of allowed values (``format={BGRA,NV12}``) — the
    GST_TYPE_LIST analog.  Order matters: the first entry is the preferred
    fixation when the target is not in the list (gst list fixation keeps
    the first subset entry)."""

    values: tuple

    def __post_init__(self):
        if not self.values:
            raise ValueError("empty value list")

    def contains(self, v) -> bool:
        return v in self.values

    def nearest(self, target):
        if target in self.values:
            return target
        try:
            t = float(target)
            return min(self.values, key=lambda v: abs(float(v) - t))
        except (TypeError, ValueError):
            return self.values[0]

    def __str__(self) -> str:
        return "{" + ",".join(str(v) for v in self.values) + "}"


def _contains(constraint, v) -> bool:
    if constraint is None:
        return True
    if isinstance(constraint, (Range, ValueList)):
        return constraint.contains(v)
    return v == constraint


def _fixate(constraint, target):
    """None -> None (unconstrained); exact -> itself; range/list -> the
    member nearest to `target`."""
    if constraint is None:
        return None
    if isinstance(constraint, (Range, ValueList)):
        return constraint.nearest(target)
    return constraint


def _split_caps_fields(text: str):
    """Split a caps string on commas at bracket depth 0 — range/list values
    (``width=[320,1280]``, ``format={BGRA,NV12}``) contain commas."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts]


@dataclass(frozen=True)
class CapsFilter:
    """Partial constraints on a FrameSpec — the analog of a caps filter
    string between two elements (``video/x-raw,format=NV12,width=320``).

    Any field left None is unconstrained.  format/width/height/fps/par can
    be an exact value, a Range (``[lo,hi]``) or a ValueList (``{a,b}``);
    elements fixate non-exact constraints nearest to their preferred value
    (gst_caps_fixate semantics — see gstvfmetalconvertscale.m:160-248)."""

    format: object | None = None  # VideoFormat | Range | ValueList
    width: object | None = None  # int | Range | ValueList
    height: object | None = None
    fps: object | None = None  # Fraction | Range | ValueList
    par: object | None = None
    interlaced: bool | None = None
    matrix: str | None = None  # explicit colorimetry constraint

    @classmethod
    def parse(cls, text: str) -> "CapsFilter":
        """Parse a gst-launch style caps string.

        Accepts 'video/x-raw' with comma-separated fields; typed values like
        '(fraction)30/1' or '(string)NV12' have their type tags stripped;
        ranges ``[lo,hi]`` and lists ``{a,b,c}`` follow gst grammar.
        """

        def parse_value(val, scalar):
            if val.startswith("[") and val.endswith("]"):
                lo, _, hi = val[1:-1].partition(",")
                return Range(scalar(lo.strip()), scalar(hi.strip()))
            if val.startswith("{") and val.endswith("}"):
                return ValueList(tuple(
                    scalar(v.strip()) for v in val[1:-1].split(",")))
            return scalar(val)

        fields: dict = {}
        for part in _split_caps_fields(text):
            if part in ("video/x-raw", ""):
                continue
            if "=" not in part:
                raise ValueError(f"bad caps field {part!r} in {text!r}")
            key, val = part.split("=", 1)
            key = key.strip()
            val = val.strip()
            if val.startswith("("):  # strip type annotation e.g. (fraction)
                val = val.split(")", 1)[1]
            if key == "format":
                fields["format"] = parse_value(val, parse_format)
            elif key == "width":
                fields["width"] = parse_value(val, int)
            elif key == "height":
                fields["height"] = parse_value(val, int)
            elif key == "framerate":
                fields["fps"] = parse_value(val, Fraction.parse)
            elif key == "pixel-aspect-ratio":
                fields["par"] = parse_value(val, Fraction.parse)
            elif key == "interlace-mode":
                fields["interlaced"] = val == "interleaved"
            elif key == "colorimetry":
                # map GStreamer colorimetry strings to the YUV matrix
                # (vf_metal_color_matrix_for_frame: BT.709 else BT.601)
                fields["matrix"] = (
                    "bt709" if "709" in val else "bt601")
            elif key == "chroma-site":
                pass  # accepted but not constrained
            else:
                raise ValueError(f"unsupported caps field {key!r}")
        return cls(**fields)

    # -- constraint accessors (fixation helpers for elements) --------------

    def is_fixed(self, field: str) -> bool:
        """True when `field` carries an EXACT value (not a range/list)."""
        v = getattr(self, field)
        return v is not None and not isinstance(v, (Range, ValueList))

    def fixate(self, field: str, target):
        """Resolve `field`'s constraint nearest to `target`; None if the
        field is unconstrained."""
        return _fixate(getattr(self, field), target)

    def accepts(self, spec: FrameSpec) -> bool:
        if not _contains(self.format, spec.format):
            return False
        if not _contains(self.width, spec.width):
            return False
        if not _contains(self.height, spec.height):
            return False
        if not _contains(self.fps, spec.fps):
            return False
        if not _contains(self.par, spec.par):
            return False
        if self.interlaced is not None and spec.interlaced != self.interlaced:
            return False
        if self.matrix is not None and spec.matrix != self.matrix:
            return False
        return True

    def apply(self, spec: FrameSpec) -> FrameSpec:
        """Constrain `spec` to this filter (fields set here win); range/list
        constraints fixate nearest to the spec's current value."""
        kw = {}
        if self.format is not None:
            kw["format"] = _fixate(self.format, spec.format)
        if self.width is not None:
            kw["width"] = _fixate(self.width, spec.width)
        if self.height is not None:
            kw["height"] = _fixate(self.height, spec.height)
        if self.fps is not None:
            kw["fps"] = _fixate(self.fps, spec.fps)
        if self.par is not None:
            kw["par"] = _fixate(self.par, spec.par)
        if self.interlaced is not None:
            kw["interlaced"] = self.interlaced
        if self.matrix is not None:
            kw["matrix"] = self.matrix
        elif ("width" in kw and kw["width"] != spec.width) or (
                "height" in kw and kw["height"] != spec.height):
            # size change re-derives the default colorimetry (HD -> BT.709,
            # SD -> BT.601), like caps renegotiation would; a spec whose
            # matrix was derived from its old size must not leak it
            kw["matrix"] = ""
        return spec.with_(**kw)
