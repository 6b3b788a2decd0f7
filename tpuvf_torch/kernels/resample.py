"""Separable 2-tap resampler: K1 (rows) and K1b (columns).

`resample_rows` is the port of tpuvf's Pallas kernel
``tpuvf/kernels/pallas/resample.py::banded_resample_rows``; `resample_cols`
of its column twin, the blockband MXU einsum
``tpuvf/kernels/sample.py::_blockband_cols``.  Together they are the whole
sampler of the canonical path: every non-identity axis of vfconvertscale goes
through them, rows first, then columns (``convert.plan_plane_sampler``).

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/resample.cu``) on the current stream; on a CPU tensor it calls the
plain PyTorch version beside it.  There is no other path: a CUDA launch that
fails raises.  Both kernels are bitwise equal to their plain versions (no FMA
contraction on either side).  Column taps come from `make_col_taps`, which
also plans the column kernel's tiles (``sample.plan_col_bands``,
``sample.stage_plan``): the input span each tile of output columns stages in
shared memory, or none where the tile gathers from device memory.

Each wrapper counts its kernel launches in ``<wrapper>.launches``, a plain
integer that a caller may reset, so a run can show that it went through the
kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuvf_torch.kernels import _build, sample


class Taps(NamedTuple):
    """Per-output 2-tap table of one axis (``sample.plan_taps``) on a
    device: out[o] = w0[o]*in[i0[o]] + w1[o]*in[i1[o]].  Column taps
    (`make_col_taps`) also carry the band plan the column kernel reads
    (``sample.plan_col_bands``, ``sample.stage_plan``); row taps do not."""

    i0: torch.Tensor  # int32 (n_out,)
    i1: torch.Tensor  # int32 (n_out,)
    w0: torch.Tensor  # float32 (n_out,)
    w1: torch.Tensor  # float32 (n_out,)
    in_size: int
    k: torch.Tensor | None = None  # int32 (2, n_out): i0, i1, dead taps in span
    stage: torch.Tensor | None = None  # int32 (n_tiles, 2): (lo4, width)
    pitch: int = 0  # floats per staged row

    @property
    def out_size(self) -> int:
        return self.i0.shape[0]


def _put(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)


def make_taps(table, in_size: int, device) -> Taps:
    """numpy (i0, i1, w0, w1) from ``sample.plan_taps`` -> tensors on
    `device`, moved once at plan time."""
    i0, i1, w0, w1 = table
    if not (len(i0) == len(i1) == len(w0) == len(w1)):
        raise ValueError("tap table columns differ in length")
    if len(i0) and (min(i0.min(), i1.min()) < 0
                    or max(i0.max(), i1.max()) >= in_size):
        raise ValueError(f"tap index out of range for in_size {in_size}")
    return Taps(_put(i0, np.int32, device), _put(i1, np.int32, device),
                _put(w0, np.float32, device), _put(w1, np.float32, device),
                int(in_size))


def make_col_taps(table, in_size: int, device) -> Taps:
    """`make_taps` for `resample_cols`, with the column kernel's band plan:
    each tile's input span, staged in shared memory, or none where the tile
    gathers from device memory."""
    taps = make_taps(table, in_size, device)
    span, k0, k1 = sample.plan_col_bands(table)
    stage, pitch = sample.stage_plan(span, in_size)
    return taps._replace(k=_put(np.stack([k0, k1]), np.int32, device),
                         stage=_put(stage, np.int32, device), pitch=pitch)


def band_taps(taps: Taps, lo: int, hi: int, base: int, n_in: int) -> Taps:
    """Row taps for the output rows [lo, hi) of `taps` (`make_taps`'),
    reading an input window of `n_in` rows that starts at input row
    `base`: the table's rows [lo, hi), their indices less `base` and
    clamped into the window.  An output row whose taps the window holds
    gets the frame's sum bit for bit; a row whose taps it does not hold
    (a band's halo rows past the element's reach) gets a clamped one, and
    the band build drops it."""
    if taps.k is not None:
        raise ValueError("band_taps: row taps only")

    def index(i):
        return (i[lo:hi] - base).clamp(0, n_in - 1).to(torch.int32)

    return Taps(index(taps.i0), index(taps.i1), taps.w0[lo:hi].contiguous(),
                taps.w1[lo:hi].contiguous(), int(n_in))


def col_paths(taps: Taps):
    """-> (tiles K1b stages in shared memory, tiles it gathers directly)."""
    staged = int((taps.stage[:, 1] > 0).sum())
    return staged, taps.stage.shape[0] - staged


# -- plain versions (CPU path; the reference the kernels are held against) --


def resample_rows_plain(x: torch.Tensor, taps: Taps) -> torch.Tensor:
    """(..., in_h, W) -> (..., out_h, W) with separate gather, mul and add
    ops."""
    a = x.index_select(-2, taps.i0)
    b = x.index_select(-2, taps.i1)
    return taps.w0[:, None] * a + taps.w1[:, None] * b


def resample_cols_plain(x: torch.Tensor, taps: Taps) -> torch.Tensor:
    """(..., H, in_w) -> (..., H, out_w) with separate gather, mul and add
    ops."""
    a = x.index_select(-1, taps.i0)
    b = x.index_select(-1, taps.i1)
    return taps.w0 * a + taps.w1 * b


# -- wrappers ---------------------------------------------------------------


def _check(x: torch.Tensor, taps: Taps, axis: int, name: str) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"{name}: expected (..., H, W), got {tuple(x.shape)}")
    if x.shape[axis] != taps.in_size:
        raise ValueError(f"{name}: axis {axis} has {x.shape[axis]} entries, "
                         f"taps expect {taps.in_size}")
    for t in _tensors(taps):
        if t.device != x.device:
            raise ValueError(f"{name}: taps on {t.device}, input on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _tensors(taps: Taps):
    return [t for t in taps[:4] + (taps.k, taps.stage) if t is not None]


def _launch(fn, x: torch.Tensor, out: torch.Tensor, tables, *sizes) -> None:
    if not x.is_contiguous():
        raise ValueError("resample kernels need a contiguous input")
    for t in tables:
        if not t.is_contiguous():
            raise ValueError("resample kernels need contiguous taps")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tables),
             *sizes, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")


def resample_rows(x: torch.Tensor, taps: Taps) -> torch.Tensor:
    """K1: resample the rows (axis -2) of float32 (..., in_h, W)."""
    _check(x, taps, -2, "resample_rows")
    if x.device.type == "cpu":
        return resample_rows_plain(x, taps)
    in_h, width = x.shape[-2], x.shape[-1]
    out = torch.empty(x.shape[:-2] + (taps.out_size, width),
                      dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    planes = x.numel() // (in_h * width)
    _launch(_build.load().resample_rows_f32, x, out, taps[:4],
            planes, in_h, taps.out_size, width)
    resample_rows.launches += 1
    return out


def resample_cols(x: torch.Tensor, taps: Taps) -> torch.Tensor:
    """K1b: resample the columns (axis -1) of float32 (..., H, in_w) with
    `make_col_taps`' taps."""
    if taps.k is None:
        raise ValueError("resample_cols: taps without a band plan "
                         "(make them with make_col_taps)")
    _check(x, taps, -1, "resample_cols")
    if x.device.type == "cpu":
        return resample_cols_plain(x, taps)
    height, in_w = x.shape[-2], x.shape[-1]
    out = torch.empty(x.shape[:-1] + (taps.out_size,),
                      dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    planes = x.numel() // (height * in_w)
    _launch(_build.load().resample_cols_f32, x, out,
            (taps.k, taps.w0, taps.w1, taps.stage),
            planes, height, in_w, taps.out_size, taps.pitch)
    resample_cols.launches += 1
    return out


resample_rows.launches = 0
resample_cols.launches = 0
