"""K4: vfcompositor's blend fold.

For every canvas pixel, the zorder fold of every draw that covers it over the
background, with the RGBA8 render target quantized after each draw (port of
the fold that tpuvf's ``render_*`` bodies run, ``tpuvf/elements/
compositor.py:855-886`` with ``_blend_static`` at ``:669-674``, and of its
Pallas prototypes ``pallas_fold`` and ``roll_bw`` in
``scripts/bench_comp_pallas.py``).

A draw is a pad's source planes, already sampled to the pad size and not yet
premultiplied: (4, h, w) uint8 (an RGB pad at identity) or float32 (a scaled
pad, or a YUV pad after the emit), placed with its (0, 0) at canvas (x, y)
and clipped to a rect inside the canvas.  Per draw and pixel of its rect::

    s = dequant(src) or src;  s_a = s[3] * k;  s_c = s[c] * s_a (c < 3)
    dv = dequant(dst)
    SOURCE: s                 OVER: s + dv * (1 - s_a)     ADD: s + dv
    dst = quant(blended)

with ``k = f32(alpha)``.  A draw whose flag is 0 is skipped (tpuvf's draw
flag: its blend would give ``dv``, and ``quant(dequant(v)) == v``).  Outside
every rect the canvas keeps the background (or 0 where the background is
not drawn).  A draw with `keep_alpha` blends channels 0-2 and leaves the
canvas's alpha: with OVER and ``k`` the overlay's alpha it is a folded
vfoverlay's mix draw, tpuvf's ``quant(dequant(v) * (1 - a) + ov * a)``,
``a = ov_3 * alpha`` (``tpuvf/elements/compositor.py:676-686``), on the
overlay's float32 rect planes (`overlay.overlay_rect`).

**The draw table.**  What changes from frame to frame (each draw's
position, clamped rect, operator, alpha and flag, and whether the
background is drawn) lies in a small int32 table on the canvas's device,
`pack_table`'s layout: ``[bg_drawn, (x, y, x0, y0, x1, y1, op, k, drawn)
per draw]`` in frame coordinates, ``k`` as its float32 bits (``xpos`` has
the full int range, which float32 does not hold).  The vfcompositor
computes it on the host each frame and stages it with one pinned
non-blocking copy, as the scalars are staged (`runtime/staging.py`).  What
the launch takes by value is only what a frame's graph fixes: the canvas
size and row origin, the draw count and chunking, each draw's source
pointer, type, size and `keep_alpha`.  So a moving pad changes no launch
argument, and a captured CUDA graph replays it (`runtime/compiled.py`).
The kernel reads the table on the card, clamps each rect to the canvas (a
row band's rows ``[row0, row0 + height)``) and to its placed source, and
decides there whether it reads the draw 4 pixels at a time
(`draw_vector_path`'s rule).

On a CUDA canvas device `composite_fold` launches the hand-written kernel
``composite_fold`` (``csrc/composite.cu``) on the current stream, one launch
per `MAX_DRAWS` draws, each later launch folding onto the canvas the one
before wrote; on the CPU it calls `composite_fold_plain`, which reads the
same table on the host (`placed_draws`) and folds the placed draws in torch
ops (`fold_draws_plain`), op for op as tpuvf's ``render_fast``.  There is
no other path: a CUDA launch that fails raises.  The kernel is bitwise
equal to the plain version (no FMA contraction on either side).
`pack_draws` turns a list of placed `Draw`s into sources and a table.

The wrapper counts its kernel launches in ``composite_fold.launches``.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Iterable, NamedTuple, Sequence

import numpy as np
import torch

from tpuvf_torch.kernels import _build
from tpuvf_torch.kernels.color import as_float, dequant, quant

OP_SOURCE, OP_OVER, OP_ADD = 0, 1, 2  # csrc/composite.cu enum Op
MAX_DRAWS = 8  # draws one launch holds (csrc/composite.cu kMaxDraws)
TABLE_HEAD = 1  # bg_drawn (csrc/composite.cu kTableHead)
TABLE_FIELDS = 9  # x, y, x0, y0, x1, y1, op, k bits, drawn (kTableFields)


class Background(NamedTuple):
    """The cleared render target: ``colors[cell]`` are (r, g, b, a) uint8
    values, ``cell = ((x // 8) + ((y + row0) // 8)) % 2`` (both cells equal
    for a solid background).  `row0` is the frame row of the canvas's row 0:
    a row band's canvas keeps the frame's checker and reads the table's
    frame coordinates.  Whether it is drawn is the table's."""

    colors: tuple  # ((r, g, b, a), (r, g, b, a)) ints 0..255
    row0: int = 0


class Source(NamedTuple):
    """One draw's source as the launch takes it (the table places it)."""

    planes: torch.Tensor  # (4, h, w) uint8 or float32
    keep_alpha: bool = False  # blend channels 0-2 only (the overlay mix)


class Draw(NamedTuple):
    """One placed draw of the fold, in the canvas's coordinates (see the
    module doc); `pack_draws` packs a list of them into a table."""

    src: torch.Tensor  # (4, h, w) uint8 or float32 planes
    x: int  # canvas column of src[:, :, 0]
    y: int  # canvas row of src[:, 0, :]
    rect: tuple  # (x0, y0, x1, y1): inside the canvas and the placed source
    op: int  # OP_SOURCE, OP_OVER or OP_ADD
    k: float  # f32(alpha), a Python float holding a float32 value
    draw: int = 1  # the draw flag: 0 skips the draw
    keep_alpha: bool = False  # blend channels 0-2 only (the overlay mix)


def background_colors(mode_rgba: Sequence) -> tuple:
    """(r, g, b, a) floats of each checker cell -> the two uint8 colors,
    quantized as tpuvf quantizes its background canvas (numpy round half to
    even of the float32 values)."""
    f = np.asarray(mode_rgba, np.float32).reshape(2, 4)
    q = np.round(np.clip(f, 0, 1) * 255).astype(np.uint8)
    return tuple(tuple(int(v) for v in row) for row in q)


def table_size(n_draws: int) -> int:
    """int32 entries of the table of `n_draws` draws."""
    return TABLE_HEAD + TABLE_FIELDS * n_draws


def _i32(v: int) -> int:
    return min(max(int(v), -2**31), 2**31 - 1)


def _f32_bits(k: float) -> int:
    return struct.unpack("<i", struct.pack("<f", k))[0]


def pack_table(bg_drawn: bool, rows: Iterable[tuple],
               out: np.ndarray | None = None) -> np.ndarray:
    """The draw table (module doc) of `rows`, each ``(x, y, (x0, y0, x1,
    y1), op, k, drawn)`` in frame coordinates, into `out` (an int32 array
    of `table_size` entries) or a new array.  x and y saturate at the int32
    range (a pad's centering offset can carry an xpos past it): a draw
    placed beyond it has an empty rect, which reads neither."""
    rows = list(rows)
    if out is None:
        out = np.empty(table_size(len(rows)), np.int32)
    if out.dtype != np.int32 or out.shape != (table_size(len(rows)),):
        raise ValueError(f"pack_table: {len(rows)} draws need an int32 "
                         f"({table_size(len(rows))},) table")
    out[0] = int(bool(bg_drawn))
    for i, (x, y, rect, op, k, drawn) in enumerate(rows):
        if op not in (OP_SOURCE, OP_OVER, OP_ADD):
            raise ValueError(f"composite_fold: unknown operator {op}")
        at = TABLE_HEAD + TABLE_FIELDS * i
        out[at:at + TABLE_FIELDS] = (_i32(x), _i32(y), *rect, op,
                                     _f32_bits(k), int(bool(drawn)))
    return out


def _check_draw(d: Draw, height: int, width: int) -> None:
    x0, y0, x1, y1 = d.rect
    if x1 <= x0 or y1 <= y0:
        return  # an empty rect reads nothing
    h, w = d.src.shape[-2], d.src.shape[-1]
    if not (0 <= x0 and 0 <= y0 and x1 <= width and y1 <= height
            and d.x <= x0 and d.y <= y0 and x1 <= d.x + w and y1 <= d.y + h):
        raise ValueError(f"composite_fold: rect {d.rect} leaves the "
                         f"{width}x{height} canvas or the {w}x{h} source "
                         f"placed at ({d.x}, {d.y})")


def pack_draws(height: int, width: int, draws: Sequence[Draw],
               bg_drawn: bool = True, row0: int = 0):
    """Placed draws of a (height, width) canvas whose row 0 is frame row
    `row0` -> (sources, the int32 table on the CPU), after checking that
    each rect lies inside the canvas and its placed source."""
    for d in draws:
        _check_draw(d, height, width)
    sources = [Source(d.src, d.keep_alpha) for d in draws]
    table = pack_table(bg_drawn, (
        (d.x, d.y + row0, (d.rect[0], d.rect[1] + row0, d.rect[2],
                           d.rect[3] + row0), d.op, d.k, d.draw)
        for d in draws))
    return sources, torch.from_numpy(table)


# -- the plain version (CPU path; the reference the kernel is held against) --


def background_canvas(height: int, width: int, background: Background,
                      drawn: bool, device) -> torch.Tensor:
    """The cleared (4, H, W) uint8 canvas (0 where the background is not
    drawn)."""
    if not drawn:
        return torch.zeros((4, height, width), dtype=torch.uint8,
                           device=device)
    colors = torch.tensor(background.colors, dtype=torch.uint8, device=device)
    ys = (torch.arange(height, device=device) + background.row0) // 8
    xs = torch.arange(width, device=device) // 8
    cell = (ys[:, None] + xs[None, :]) % 2
    return colors[cell].permute(2, 0, 1).contiguous()


def fold_draws_plain(height: int, width: int, background: Background,
                     bg_drawn: bool, draws: Sequence[Draw],
                     device) -> torch.Tensor:
    """The fold of placed draws in torch ops -> (4, H, W) uint8 canvas."""
    dst = background_canvas(height, width, background, bg_drawn, device)
    for d in draws:
        x0, y0, x1, y1 = d.rect
        if x1 <= x0 or y1 <= y0 or not d.draw:
            continue
        s = as_float(d.src[:, y0 - d.y:y1 - d.y, x0 - d.x:x1 - d.x])
        s_a = s[3] * d.k
        src = (s[0] * s_a, s[1] * s_a, s[2] * s_a, s_a)
        for c in range(3 if d.keep_alpha else 4):
            dst_v = dequant(dst[c, y0:y1, x0:x1])
            if d.op == OP_SOURCE:
                blended = src[c]
            elif d.op == OP_ADD:
                blended = src[c] + dst_v
            else:
                blended = src[c] + dst_v * (1.0 - s_a)
            dst[c, y0:y1, x0:x1] = quant(blended)
    return dst


def placed_draws(height: int, width: int, background: Background,
                 sources: Sequence[Source], table) -> tuple:
    """The table read as the kernel reads it -> (bg_drawn, [Draw]) on the
    canvas: each rect clamped to the canvas rows ``[row0, row0 + height)``
    and columns, and to its placed source, then moved to the canvas's
    rows; a draw whose flag is 0 gets an empty rect."""
    t = [int(v) for v in torch.as_tensor(table).tolist()]
    row0 = background.row0
    draws = []
    for i, s in enumerate(sources):
        x, y, tx0, ty0, tx1, ty1, op, k, drawn = t[
            TABLE_HEAD + TABLE_FIELDS * i:TABLE_HEAD + TABLE_FIELDS * (i + 1)]
        h, w = s.planes.shape[-2], s.planes.shape[-1]
        x0, x1 = max(tx0, x, 0), min(tx1, x + w, width)
        y0, y1 = max(ty0, y, row0), min(ty1, y + h, row0 + height)
        if not drawn or x1 <= x0 or y1 <= y0:
            x0 = y0 = x1 = y1 = 0
        kf = struct.unpack("<f", struct.pack("<i", k))[0]
        draws.append(Draw(s.planes, x, y - row0, (x0, y0 - row0, x1,
                                                  y1 - row0),
                          op, kf, 1, s.keep_alpha))
    return bool(t[0]), draws


def composite_fold_plain(height: int, width: int, background: Background,
                         sources: Sequence[Source], table,
                         device) -> torch.Tensor:
    """The fold of the draw table in torch ops -> (4, H, W) uint8 canvas
    (the table is read on the host: a CUDA table waits for the device)."""
    bg_drawn, draws = placed_draws(height, width, background, sources, table)
    return fold_draws_plain(height, width, background, bg_drawn, draws,
                            device)


# -- the kernel wrapper ------------------------------------------------------


class DrawDesc(ctypes.Structure):
    """csrc/composite.cu `DrawDesc`, field for field."""

    _fields_ = [("src", ctypes.c_void_p), ("src_f32", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("keep_alpha", ctypes.c_int), ("aligned", ctypes.c_int)]


class FoldParams(ctypes.Structure):
    """csrc/composite.cu `FoldParams`, field for field: the kernel's
    by-value parameter."""

    _fields_ = [("draws", DrawDesc * MAX_DRAWS), ("table", ctypes.c_void_p),
                ("first", ctypes.c_int), ("n_draws", ctypes.c_int),
                ("height", ctypes.c_int), ("width", ctypes.c_int),
                ("from_canvas", ctypes.c_int), ("row0", ctypes.c_int),
                ("bg", (ctypes.c_uint8 * 4) * 2)]


def _check(sources: Sequence[Source], table: torch.Tensor, device) -> None:
    for s in sources:
        src = s.planes
        if src.dim() != 3 or src.shape[0] != 4:
            raise ValueError(f"composite_fold: a draw source must be (4, h, "
                             f"w), got {tuple(src.shape)}")
        if src.dtype not in (torch.uint8, torch.float32):
            raise TypeError(f"composite_fold: draw sources must be uint8 or "
                            f"float32, got {src.dtype}")
        if src.device != device:
            raise ValueError(f"composite_fold: a draw source on "
                             f"{src.device}, canvas on {device}")
    if (not isinstance(table, torch.Tensor) or table.dtype != torch.int32
            or tuple(table.shape) != (table_size(len(sources)),)):
        raise ValueError(f"composite_fold: {len(sources)} draws need an "
                         f"int32 ({table_size(len(sources))},) table")
    if table.device != device:
        raise ValueError(f"composite_fold: the table on {table.device}, "
                         f"canvas on {device}")


def _fold_params(height, width, background, chunk, first, table,
                 from_canvas) -> FoldParams:
    p = FoldParams()
    p.table, p.first, p.n_draws = table.data_ptr(), first, len(chunk)
    p.height, p.width = height, width
    p.from_canvas, p.row0 = int(from_canvas), background.row0
    for cell in range(2):
        for c in range(4):
            p.bg[cell][c] = background.colors[cell][c]
    for desc, s in zip(p.draws, chunk):
        if not s.planes.is_contiguous():
            raise ValueError("composite_fold: the kernel needs contiguous "
                             "draw sources")
        desc.src = s.planes.data_ptr()
        desc.src_f32 = int(s.planes.dtype == torch.float32)
        desc.height, desc.width = s.planes.shape[1], s.planes.shape[2]
        desc.keep_alpha = int(s.keep_alpha)
    return p


def draw_vector_path(d: Draw) -> bool:
    """Whether K4 reads this draw's source 4 pixels at a time (one uchar4
    or float4 a plane): the rule ``draw_vector`` of csrc/composite.cu, which
    the kernel applies per draw to the table's x.  The kernel's quads start
    on canvas columns that are multiples of 4, so the placement must keep
    them aligned in the source, every source row must start on a quad, and
    the base must sit on the access (4 bytes uint8, 16 bytes float32)."""
    access = 16 if d.src.dtype == torch.float32 else 4
    return (d.x % 4 == 0 and d.src.shape[2] % 4 == 0
            and d.src.data_ptr() % access == 0)


def composite_fold(height: int, width: int, background: Background,
                   sources: Sequence[Source], table: torch.Tensor,
                   device) -> torch.Tensor:
    """K4: `composite_fold_plain`'s fold of the draw table on the card,
    writing the canvas once per `MAX_DRAWS` draws.  The table lies on the
    canvas's device; on the card the kernel reads it there."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    _check(sources, table, device)
    if device.type == "cpu":
        return composite_fold_plain(height, width, background, sources,
                                    table, device)
    if device.type != "cuda":
        raise ValueError(f"composite_fold: unsupported device {device}")
    out = torch.empty((4, height, width), dtype=torch.uint8, device=device)
    if out.numel() == 0:
        return out
    if not table.is_contiguous():
        raise ValueError("composite_fold: the kernel needs a contiguous table")
    lib = _build.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    for first in range(0, max(len(sources), 1), MAX_DRAWS):
        chunk = sources[first:first + MAX_DRAWS]
        params = _fold_params(height, width, background, chunk, first, table,
                              first > 0)
        err = lib.composite_fold(ctypes.addressof(params), out.data_ptr(),
                                 stream)
        if err != 0:
            raise RuntimeError(f"composite_fold launch failed: cudaError "
                               f"{err}")
        composite_fold.launches += 1
    return out


composite_fold.launches = 0
