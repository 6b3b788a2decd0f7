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
    SOURCE: draw ? s : dv     OVER: s + dv * (1 - s_a)     ADD: s + dv
    dst = quant(blended)

with ``k = f32(alpha) * draw``.  Outside every rect the canvas keeps the
background (or 0 where the background is not drawn).  A draw with
`keep_alpha` blends channels 0-2 and leaves the canvas's alpha: with OVER
and ``k`` the overlay's alpha it is a folded vfoverlay's mix draw, tpuvf's
``quant(dequant(v) * (1 - a) + ov * a)``, ``a = ov_3 * alpha``
(``tpuvf/elements/compositor.py:676-686``), on the overlay's float32 rect
planes (`overlay.overlay_rect`).

On a CUDA canvas device `composite_fold` launches the hand-written kernel
``composite_fold`` (``csrc/composite.cu``) on the current stream, one launch
per `MAX_DRAWS` draws, each later launch folding onto the canvas the one
before wrote; on the CPU it calls `composite_fold_plain`, the same fold in
torch ops, op for op as tpuvf's ``render_fast``.  There is no other path: a
CUDA launch that fails raises.  The kernel is bitwise equal to the plain
version (no FMA contraction on either side).  It folds 4 pixels of a row a
thread; each draw's source is read 4 pixels at a time where
`draw_vector_path` holds (the launcher's rule, mirrored here), else pixel
by pixel.

The wrapper counts its kernel launches in ``composite_fold.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch

from tpuvf_torch.kernels import _build
from tpuvf_torch.kernels.color import as_float, dequant, quant

OP_SOURCE, OP_OVER, OP_ADD = 0, 1, 2  # csrc/composite.cu enum Op
MAX_DRAWS = 8  # draws one launch holds (csrc/composite.cu kMaxDraws)


class Background(NamedTuple):
    """The cleared render target: ``colors[cell]`` are (r, g, b, a) uint8
    values, ``cell = ((x // 8) + ((y + row0) // 8)) % 2`` (both cells equal
    for a solid background); where `drawn` is False the canvas starts at 0.
    `row0` is the frame row of the canvas's row 0: a row band's canvas keeps
    the frame's checker."""

    colors: tuple  # ((r, g, b, a), (r, g, b, a)) ints 0..255
    drawn: bool
    row0: int = 0


class Draw(NamedTuple):
    """One draw of the fold (see the module doc)."""

    src: torch.Tensor  # (4, h, w) uint8 or float32 planes
    x: int  # canvas column of src[:, :, 0]
    y: int  # canvas row of src[:, 0, :]
    rect: tuple  # (x0, y0, x1, y1): inside the canvas and the placed source
    op: int  # OP_SOURCE, OP_OVER or OP_ADD
    k: float  # f32(alpha) * draw, a Python float holding a float32 value
    draw: int = 1  # the draw flag (SOURCE keeps the canvas where it is 0)
    keep_alpha: bool = False  # blend channels 0-2 only (the overlay mix)


def background_colors(mode_rgba: Sequence) -> tuple:
    """(r, g, b, a) floats of each checker cell -> the two uint8 colors,
    quantized as tpuvf quantizes its background canvas (numpy round half to
    even of the float32 values)."""
    f = np.asarray(mode_rgba, np.float32).reshape(2, 4)
    q = np.round(np.clip(f, 0, 1) * 255).astype(np.uint8)
    return tuple(tuple(int(v) for v in row) for row in q)


# -- the plain version (CPU path; the reference the kernel is held against) --


def background_canvas(height: int, width: int, background: Background,
                      device) -> torch.Tensor:
    """The cleared (4, H, W) uint8 canvas."""
    if not background.drawn:
        return torch.zeros((4, height, width), dtype=torch.uint8,
                           device=device)
    colors = torch.tensor(background.colors, dtype=torch.uint8, device=device)
    ys = (torch.arange(height, device=device) + background.row0) // 8
    xs = torch.arange(width, device=device) // 8
    cell = (ys[:, None] + xs[None, :]) % 2
    return colors[cell].permute(2, 0, 1).contiguous()


def composite_fold_plain(height: int, width: int, background: Background,
                         draws: Sequence[Draw], device) -> torch.Tensor:
    """The fold in torch ops -> (4, H, W) uint8 canvas."""
    dst = background_canvas(height, width, background, device)
    for d in draws:
        x0, y0, x1, y1 = d.rect
        if x1 <= x0 or y1 <= y0:
            continue
        s = as_float(d.src[:, y0 - d.y:y1 - d.y, x0 - d.x:x1 - d.x])
        s_a = s[3] * d.k
        src = (s[0] * s_a, s[1] * s_a, s[2] * s_a, s_a)
        for c in range(3 if d.keep_alpha else 4):
            dst_v = dequant(dst[c, y0:y1, x0:x1])
            if d.op == OP_SOURCE:
                blended = src[c] if d.draw > 0 else dst_v
            elif d.op == OP_ADD:
                blended = src[c] + dst_v
            else:
                blended = src[c] + dst_v * (1.0 - s_a)
            dst[c, y0:y1, x0:x1] = quant(blended)
    return dst


# -- the kernel wrapper ------------------------------------------------------


class DrawDesc(ctypes.Structure):
    """csrc/composite.cu `DrawDesc`, field for field."""

    _fields_ = [("src", ctypes.c_void_p), ("src_f32", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("x", ctypes.c_int), ("y", ctypes.c_int),
                ("x0", ctypes.c_int), ("y0", ctypes.c_int),
                ("x1", ctypes.c_int), ("y1", ctypes.c_int),
                ("op", ctypes.c_int), ("k", ctypes.c_float),
                ("draw", ctypes.c_int), ("keep_alpha", ctypes.c_int),
                ("vector", ctypes.c_int)]


class FoldParams(ctypes.Structure):
    """csrc/composite.cu `FoldParams`, field for field: the kernel's
    by-value parameter."""

    _fields_ = [("draws", DrawDesc * MAX_DRAWS), ("n_draws", ctypes.c_int),
                ("height", ctypes.c_int), ("width", ctypes.c_int),
                ("bg_drawn", ctypes.c_int), ("from_canvas", ctypes.c_int),
                ("row0", ctypes.c_int), ("bg", (ctypes.c_uint8 * 4) * 2)]


def _check_draw(d: Draw, height: int, width: int, device) -> None:
    src = d.src
    if src.dim() != 3 or src.shape[0] != 4:
        raise ValueError(f"composite_fold: a draw source must be (4, h, w), "
                         f"got {tuple(src.shape)}")
    if src.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"composite_fold: draw sources must be uint8 or "
                        f"float32, got {src.dtype}")
    if src.device != device:
        raise ValueError(f"composite_fold: a draw source on {src.device}, "
                         f"canvas on {device}")
    if d.op not in (OP_SOURCE, OP_OVER, OP_ADD):
        raise ValueError(f"composite_fold: unknown operator {d.op}")
    h, w = src.shape[1], src.shape[2]
    x0, y0, x1, y1 = d.rect
    if x1 <= x0 or y1 <= y0:
        return  # an empty rect reads nothing
    if not (0 <= x0 and 0 <= y0 and x1 <= width and y1 <= height
            and d.x <= x0 and d.y <= y0 and x1 <= d.x + w and y1 <= d.y + h):
        raise ValueError(f"composite_fold: rect {d.rect} leaves the "
                         f"{width}x{height} canvas or the {w}x{h} source "
                         f"placed at ({d.x}, {d.y})")


def _fold_params(height, width, background, chunk, from_canvas) -> FoldParams:
    p = FoldParams()
    p.n_draws, p.height, p.width = len(chunk), height, width
    p.bg_drawn, p.from_canvas = int(background.drawn), int(from_canvas)
    p.row0 = background.row0
    for cell in range(2):
        for c in range(4):
            p.bg[cell][c] = background.colors[cell][c]
    for desc, d in zip(p.draws, chunk):
        if not d.src.is_contiguous():
            raise ValueError("composite_fold: the kernel needs contiguous "
                             "draw sources")
        desc.src = d.src.data_ptr()
        desc.src_f32 = int(d.src.dtype == torch.float32)
        desc.height, desc.width = d.src.shape[1], d.src.shape[2]
        desc.x, desc.y = d.x, d.y
        desc.x0, desc.y0, desc.x1, desc.y1 = d.rect
        desc.op, desc.k, desc.draw = d.op, d.k, d.draw
        desc.keep_alpha = int(d.keep_alpha)
    return p


def draw_vector_path(d: Draw) -> bool:
    """Whether K4 reads this draw's source 4 pixels at a time (one uchar4
    or float4 a plane): the rule ``draw_vector`` of csrc/composite.cu, which
    the launcher applies per draw.  The kernel's quads start on canvas
    columns that are multiples of 4, so the placement must keep them
    aligned in the source, every source row must start on a quad, and the
    base must sit on the access (4 bytes uint8, 16 bytes float32)."""
    access = 16 if d.src.dtype == torch.float32 else 4
    return (d.x % 4 == 0 and d.src.shape[2] % 4 == 0
            and d.src.data_ptr() % access == 0)


def composite_fold(height: int, width: int, background: Background,
                   draws: Sequence[Draw], device) -> torch.Tensor:
    """K4: `composite_fold_plain`'s fold on the card, writing the canvas
    once per `MAX_DRAWS` draws."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    for d in draws:
        _check_draw(d, height, width, device)
    if device.type == "cpu":
        return composite_fold_plain(height, width, background, draws, device)
    if device.type != "cuda":
        raise ValueError(f"composite_fold: unsupported device {device}")
    out = torch.empty((4, height, width), dtype=torch.uint8, device=device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    stream = torch.cuda.current_stream(device).cuda_stream
    chunks = [draws[i:i + MAX_DRAWS]
              for i in range(0, len(draws), MAX_DRAWS)] or [()]
    for i, chunk in enumerate(chunks):
        params = _fold_params(height, width, background, chunk, i > 0)
        err = lib.composite_fold(ctypes.addressof(params), out.data_ptr(),
                                 stream)
        if err != 0:
            raise RuntimeError(f"composite_fold launch failed: cudaError "
                               f"{err}")
        composite_fold.launches += 1
    return out


composite_fold.launches = 0
