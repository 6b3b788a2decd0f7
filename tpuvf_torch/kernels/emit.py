"""K2: the fused emit of vfconvertscale and vfvideofilter.

After the sampler (K1/K1b) has brought the input planes to the output grid,
every element of the canonical path emits RGBA the same way: dequantize ->
``color.yuv_to_rgb`` (YUV sources) -> the letterbox border ->
vfvideofilter's ``filter.apply_color_adjustments_t`` (when on) -> quantize to
the RGBA8 render target, or float32 channels when the 3D LUT (K3) follows.
`emit` is the port of tpuvf's quad-emit Pallas probes
(``scripts/probe_mosaic_emit.py``), whose product is that chain, which XLA
fuses on the TPU.

On a CUDA tensor `emit` launches the hand-written kernel ``emit_u8`` or
``emit_f32`` (``csrc/emit.cu``, by the source planes' type) on the current
stream; on a CPU tensor it calls `emit_plain`, which composes the port's
torch functions op for op.  There is no other path: a CUDA launch that
fails raises.  The kernel is bitwise equal to its plain version on the card
(see the source note for where that could break first: gamma's ``powf``).
Each launch takes the kernel's vector path (4 pixels of every plane a
thread) where every plane starts on the boundary of its access, else its
scalar path (one pixel a thread); the kernel's launcher decides from the
pointers and H*W.  A stack whose H*W is not a multiple of 4, and ``v`` as a
view into the sampler's stacked (2, H, W) chroma, take the scalar path.

The wrapper counts its kernel launches in ``emit.launches``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuvf_torch.kernels import _build, color
from tpuvf_torch.kernels.filter import GATES, apply_color_adjustments_t

# per-frame scalars, in the kernel's slot order (csrc/emit.cu Param), then
# coords["two_pi"]
PARAM_KEYS = ("brightness", "contrast", "saturation", "hue", "gamma", "sepia",
              "invert", "chroma_key_enabled", "key_r", "key_g", "key_b",
              "key_tolerance", "key_smoothness", "vignette", "noise")


class Border(NamedTuple):
    """Letterbox border of an output grid, on its device: pixel (y, x) keeps
    its sample iff rows[y] and cols[x]; elsewhere it takes `color`."""

    rows: torch.Tensor  # bool (H,)
    cols: torch.Tensor  # bool (W,)
    color: tuple  # (r, g, b, a) Python floats holding float32 values


class Adjust(NamedTuple):
    """vfvideofilter's adjustment chain for one frame (the arguments of
    ``filter.apply_color_adjustments_t``)."""

    params: dict  # 0-dim float32 tensors, PARAM_KEYS among them
    frame_index: torch.Tensor  # 0-dim int64
    coords: dict  # filter.plan_coords of the frame
    gates: dict  # static bools, filter.GATES


def emit_plain(src: dict, matrix_index: int, border: Border | None = None,
               adjust: Adjust | None = None,
               out_float: bool = False) -> torch.Tensor:
    """src: {"rgba": (4, H, W)} or {"y", "u", "v": (H, W)} planes at the
    output grid (uint8, or float32 from the sampler) -> (4, H, W) uint8
    RGBA planes, or float32 channels when `out_float`."""
    if "rgba" in src:
        chans = tuple(color.as_float(src["rgba"]).unbind(-3))
    else:
        r, g, b = color.yuv_to_rgb(color.as_float(src["y"]), src["u"],
                                   src["v"], matrix_index)
        chans = (r, g, b, torch.ones_like(r))
    if border is not None:
        mask = border.rows[:, None] & border.cols[None, :]
        chans = tuple(torch.where(mask, c, border.color[i])
                      for i, c in enumerate(chans))
    if adjust is not None:
        chans = apply_color_adjustments_t(chans, adjust.params,
                                          adjust.frame_index, adjust.coords,
                                          adjust.gates)
    if not out_float:
        chans = tuple(color.quant(c) for c in chans)
    return torch.stack(chans, dim=-3)


# -- the kernel wrapper ------------------------------------------------------


def _planes(src: dict):
    """-> (source tensor, u, v, height, width) after checking the shapes."""
    if "rgba" in src:
        x = src["rgba"]
        if x.dim() != 3 or x.shape[0] != 4:
            raise ValueError(f"emit: rgba must be (4, H, W), got "
                             f"{tuple(x.shape)}")
        return x, None, None, x.shape[1], x.shape[2]
    y, u, v = src["y"], src["u"], src["v"]
    if y.dim() != 2 or u.shape != y.shape or v.shape != y.shape:
        raise ValueError(f"emit: y, u, v must be (H, W) planes of one shape, "
                         f"got {tuple(y.shape)}, {tuple(u.shape)}, "
                         f"{tuple(v.shape)}")
    if u.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"emit: u and v must be float32, got {u.dtype} and "
                        f"{v.dtype}")
    return y, u, v, y.shape[0], y.shape[1]


def _ptr(t: torch.Tensor, device, name: str) -> int:
    if t.device != device:
        raise ValueError(f"emit: {name} on {t.device}, planes on {device}")
    if not t.is_contiguous():
        raise ValueError(f"emit: the kernel needs a contiguous {name}")
    return t.data_ptr()


def emit(src: dict, matrix_index: int, border: Border | None = None,
         adjust: Adjust | None = None, out_float: bool = False) -> torch.Tensor:
    """K2: `emit_plain`'s chain in one launch on the card."""
    x, u, v, height, width = _planes(src)
    if x.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"emit: source planes must be uint8 or float32, got "
                        f"{x.dtype}")
    if matrix_index not in (0, 1):
        raise ValueError(f"emit: matrix_index must be 0 or 1, got "
                         f"{matrix_index}")
    if x.device.type == "cpu":
        return emit_plain(src, matrix_index, border, adjust, out_float)
    if x.device.type != "cuda":
        raise ValueError(f"emit: unsupported device {x.device}")
    dev = x.device
    out = torch.empty((4, height, width), device=dev,
                      dtype=torch.float32 if out_float else torch.uint8)
    if out.numel() == 0:
        return out
    ptrs = [_ptr(x, dev, "source"),
            None if u is None else _ptr(u, dev, "u"),
            None if v is None else _ptr(v, dev, "v")]
    rows = cols = None
    bcolor = (0.0, 0.0, 0.0, 0.0)
    if border is not None:
        if (border.rows.dtype != torch.bool or border.cols.dtype != torch.bool
                or tuple(border.rows.shape) != (height,)
                or tuple(border.cols.shape) != (width,)):
            raise ValueError("emit: border rows/cols must be bool (H,) and (W,)")
        rows = _ptr(border.rows, dev, "border rows")
        cols = _ptr(border.cols, dev, "border cols")
        bcolor = tuple(border.color)
    gates = -1
    adj = [None] * 6
    if adjust is not None:
        params = torch.stack([adjust.params[k] for k in PARAM_KEYS]
                             + [adjust.coords["two_pi"]])
        if params.dtype != torch.float32 or params.shape != (16,):
            raise TypeError("emit: adjustment params must be 0-dim float32")
        fi = adjust.frame_index
        if fi.dtype != torch.int64 or fi.dim() != 0:
            raise TypeError("emit: frame_index must be a 0-dim int64 tensor")
        coords = adjust.coords
        if (coords["tx"].numel() != width or coords["px"].numel() != width
                or coords["ty"].numel() != height
                or coords["py"].numel() != height):
            raise ValueError("emit: coords do not match the frame")
        adj = [_ptr(params, dev, "params"), _ptr(fi, dev, "frame_index")] + [
            _ptr(coords[k], dev, k) for k in ("tx", "ty", "px", "py")]
        gates = sum(1 << i for i, g in enumerate(GATES) if adjust.gates[g])
    lib = _build.load()
    fn = lib.emit_u8 if x.dtype == torch.uint8 else lib.emit_f32
    err = fn(ptrs[0], ptrs[1], ptrs[2], int(u is None), out.data_ptr(),
             int(out_float), height, width, matrix_index, rows, cols,
             *bcolor, *adj, gates, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")
    emit.launches += 1
    return out


emit.launches = 0
