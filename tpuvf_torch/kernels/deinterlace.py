"""K5: vfdeinterlace's field kernel (port of ``tpuvf.kernels.deinterlace``,
the canonical full-frame forms `bob_t`, `weave_t` and `greedyh_t` with the
element's first-frame fallback).

On the RGBA8 texture of the input (``cur``, (4, H, W) uint8) and of the
previous input (``prev``), every row of the kept field is copied and every
other row is replaced::

    keep  = (row % 2 == 0) == tff               (rows of the full frame)
    bob   = (dq(row - 1) + dq(row + 1)) * 0.5   (edge rows clamped)
    bob, linear: bob            weave: dq(prev)
    greedy-H:    dq(prev) where sqrt(d0*d0 + d1*d1 + d2*d2) < threshold,
                 else bob       (d_c = dq(cur_c) - dq(prev_c), c < 3)
    out   = quant(...)

weave and greedy-H take bob while there is no previous frame (``has_prev``
False).  ``linear`` is bob: the reference shader computes four taps and uses
the two-tap average.

On a CUDA tensor `deinterlace` launches the hand-written kernel
``deinterlace_u8`` (``csrc/deinterlace.cu``) on the current stream; on a CPU
tensor it calls `deinterlace_plain`, the same expressions in torch ops.
There is no other path: a CUDA launch that fails raises.  The kernel is
bitwise equal to the plain version (no FMA contraction on either side).

The wrapper counts its kernel launches in ``deinterlace.launches``.
"""

from __future__ import annotations

import torch

from tpuvf_torch.kernels import _build
from tpuvf_torch.kernels.color import dequant, quant

# vfdeinterlace's method enum (csrc/deinterlace.cu enum Method)
METHOD_BOB, METHOD_WEAVE, METHOD_LINEAR, METHOD_GREEDYH = 0, 1, 2, 3


def _reads_prev(method: int, has_prev: bool) -> bool:
    return has_prev and method in (METHOD_WEAVE, METHOD_GREEDYH)


# -- the plain version (CPU path; the reference the kernel is held against) --


def deinterlace_plain(cur: torch.Tensor, prev: torch.Tensor | None,
                      method: int, tff: bool, has_prev: bool,
                      threshold: torch.Tensor) -> torch.Tensor:
    """(4, H, W) uint8 textures -> (4, H, W) uint8 output (module doc)."""
    height = cur.shape[-2]
    rows = torch.arange(height, device=cur.device)
    keep = ((rows % 2 == 0) == bool(tff))[:, None]
    c = dequant(cur)
    up = c.index_select(-2, (rows - 1).clamp(min=0))
    down = c.index_select(-2, (rows + 1).clamp(max=height - 1))
    repl = (up + down) * 0.5
    if _reads_prev(method, has_prev):
        p = dequant(prev)
        if method == METHOD_WEAVE:
            repl = p
        else:
            d = c[:3] - p[:3]
            motion = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
            repl = torch.where(motion < threshold, p, repl)
    return quant(torch.where(keep, c, repl))


# -- the kernel wrapper ------------------------------------------------------


def _check(cur, prev, method, threshold, reads_prev) -> None:
    if cur.dtype != torch.uint8 or cur.dim() != 3 or cur.shape[0] != 4:
        raise ValueError(f"deinterlace: cur must be (4, H, W) uint8, got "
                         f"{cur.dtype}{tuple(cur.shape)}")
    if method not in (METHOD_BOB, METHOD_WEAVE, METHOD_LINEAR,
                      METHOD_GREEDYH):
        raise ValueError(f"deinterlace: unknown method {method}")
    if reads_prev and (prev is None or prev.dtype != torch.uint8
                       or prev.shape != cur.shape
                       or prev.device != cur.device):
        raise ValueError("deinterlace: prev must be a uint8 tensor of cur's "
                         "shape on cur's device")
    if (threshold.dtype != torch.float32 or threshold.dim() != 0
            or threshold.device != cur.device):
        raise ValueError("deinterlace: threshold must be a 0-dim float32 "
                         "tensor on cur's device")


def deinterlace(cur: torch.Tensor, prev: torch.Tensor | None, method: int,
                tff: bool, has_prev: bool,
                threshold: torch.Tensor) -> torch.Tensor:
    """K5: `deinterlace_plain` in one launch on the card.  `tff` and
    `has_prev` are host values, so no frame waits for the device; the
    threshold stays on the device and the kernel reads it there."""
    reads_prev = _reads_prev(method, has_prev)
    _check(cur, prev, method, threshold, reads_prev)
    if cur.device.type == "cpu":
        return deinterlace_plain(cur, prev, method, tff, has_prev, threshold)
    if cur.device.type != "cuda":
        raise ValueError(f"deinterlace: unsupported device {cur.device}")
    if not cur.is_contiguous() or (reads_prev and not prev.is_contiguous()):
        raise ValueError("deinterlace: the kernel needs contiguous planes")
    out = torch.empty_like(cur)
    if out.numel() == 0:
        return out
    lib = _build.load()
    err = lib.deinterlace_u8(
        cur.data_ptr(), prev.data_ptr() if reads_prev else None,
        out.data_ptr(), threshold.data_ptr(), cur.shape[1], cur.shape[2],
        method, int(bool(tff)), torch.cuda.current_stream(cur.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"deinterlace_u8 launch failed: cudaError {err}")
    deinterlace.launches += 1
    return out


deinterlace.launches = 0
