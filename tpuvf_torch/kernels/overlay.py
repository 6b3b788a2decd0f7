"""K6: vfoverlay's rect blend, and the host resample of the overlay image
(port of ``tpuvf.elements.overlay``: `fold_draw_config` and the canonical
`make_process_linked` body).

`overlay_rect` runs at build time on the host: it resamples the
premultiplied overlay image onto the frame grid with the linear sampler and
keeps the covered rect.  It is tpuvf's numpy expression as it stands (a
float32 matmul over the full frame; a rect-only product is not guaranteed to
give the same bits from BLAS).

Per frame, on the frame's float32 RGBA (dequantized uint8 planes, or the
emit's float32 channels for YUV inputs)::

    inside the rect, c < 3:  v_c = v_c * (1 - a) + ov_c * a,  a = ov_3 * alpha
    everywhere:              out = quant(v)      (alpha channel unblended)

Outside the rect tpuvf pads the overlay with zeros, which makes its blend an
exact identity there; the kernel skips it.

On a CUDA frame `overlay_blend` launches the hand-written kernel
``overlay_blend_u8`` (``csrc/overlay.cu``) on the current stream; on a CPU
frame it calls `overlay_blend_plain`, the same expressions in torch ops.
There is no other path: a CUDA launch that fails raises.  The kernel is
bitwise equal to the plain version (no FMA contraction on either side).

The wrapper counts its kernel launches in ``overlay_blend.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvf_torch.kernels import _build, sample
from tpuvf_torch.kernels.color import as_float, quant


def overlay_rect(image: np.ndarray, width: int, height: int, ox: float,
                 oy: float, ow: float, oh: float):
    """Premultiplied (h, w, 4) uint8 image placed at (ox, oy) with size
    (ow, oh) on a width x height frame -> (rect, planes): rect (x0, x1, y0,
    y1) of the pixels whose centers it covers, planes the (4, y1 - y0,
    x1 - x0) float32 resampled image there (tpuvf's `fold_draw_config`)."""
    img_h, img_w = image.shape[:2]
    pxs = np.arange(width, dtype=np.float64) + 0.5
    pys = np.arange(height, dtype=np.float64) + 0.5
    xs = np.where((pxs >= ox) & (pxs < ox + ow))[0]
    ys = np.where((pys >= oy) & (pys < oy + oh))[0]
    rx = slice(int(xs[0]), int(xs[-1]) + 1) if len(xs) else slice(0, 0)
    ry = slice(int(ys[0]), int(ys[-1]) + 1) if len(ys) else slice(0, 0)
    tx = (pxs - ox) / ow
    ty = (pys - oy) / oh
    wx = sample.sample_matrix(np.clip(tx, 0.0, 1.0), img_w, sample.LINEAR)
    wy = sample.sample_matrix(np.clip(ty, 0.0, 1.0), img_h, sample.LINEAR)
    img_f = image.astype(np.float32) / np.float32(255.0)
    chans = img_f.transpose(2, 0, 1)
    ov_np = np.ascontiguousarray((wy @ chans) @ wx.T).astype(np.float32)
    return ((rx.start, rx.stop, ry.start, ry.stop),
            np.ascontiguousarray(ov_np[:, ry, rx]))


def _empty(rect) -> bool:
    x0, x1, y0, y1 = rect
    return x1 <= x0 or y1 <= y0


# -- the plain version (CPU path; the reference the kernel is held against) --


def overlay_blend_plain(src: torch.Tensor, rect, ov: torch.Tensor,
                        alpha: torch.Tensor) -> torch.Tensor:
    """src (4, H, W) uint8 or float32 -> (4, H, W) uint8 (module doc)."""
    v = as_float(src)
    out = quant(v)
    if not _empty(rect):
        x0, x1, y0, y1 = rect
        a = ov[3] * alpha
        out[:3, y0:y1, x0:x1] = quant(v[:3, y0:y1, x0:x1] * (1.0 - a)
                                      + ov[:3] * a)
    return out


# -- the kernel wrapper ------------------------------------------------------


def _check(src, rect, ov, alpha) -> None:
    if src.dim() != 3 or src.shape[0] != 4:
        raise ValueError(f"overlay_blend: src must be (4, H, W), got "
                         f"{tuple(src.shape)}")
    if src.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"overlay_blend: src must be uint8 or float32, got "
                        f"{src.dtype}")
    if (alpha.dtype != torch.float32 or alpha.dim() != 0
            or alpha.device != src.device):
        raise ValueError("overlay_blend: alpha must be a 0-dim float32 tensor "
                         "on src's device")
    if _empty(rect):
        return
    x0, x1, y0, y1 = rect
    if not (0 <= x0 and 0 <= y0 and x1 <= src.shape[2]
            and y1 <= src.shape[1]):
        raise ValueError(f"overlay_blend: rect {rect} leaves the "
                         f"{src.shape[2]}x{src.shape[1]} frame")
    if (ov.dtype != torch.float32 or tuple(ov.shape) != (4, y1 - y0, x1 - x0)
            or ov.device != src.device):
        raise ValueError(f"overlay_blend: ov must be float32 (4, {y1 - y0}, "
                         f"{x1 - x0}) on src's device, got {ov.dtype}"
                         f"{tuple(ov.shape)} on {ov.device}")


def overlay_blend(src: torch.Tensor, rect, ov: torch.Tensor,
                  alpha: torch.Tensor) -> torch.Tensor:
    """K6: `overlay_blend_plain` in one launch on the card; `alpha` stays on
    the device and the kernel reads it there."""
    _check(src, rect, ov, alpha)
    if src.device.type == "cpu":
        return overlay_blend_plain(src, rect, ov, alpha)
    if src.device.type != "cuda":
        raise ValueError(f"overlay_blend: unsupported device {src.device}")
    empty = _empty(rect)
    if not src.is_contiguous() or not (empty or ov.is_contiguous()):
        raise ValueError("overlay_blend: the kernel needs contiguous planes")
    out = torch.empty(src.shape, dtype=torch.uint8, device=src.device)
    if out.numel() == 0:
        return out
    x0, x1, y0, y1 = (0, 0, 0, 0) if empty else rect
    lib = _build.load()
    err = lib.overlay_blend_u8(
        src.data_ptr(), int(src.dtype == torch.float32), out.data_ptr(),
        src.shape[1], src.shape[2], None if empty else ov.data_ptr(),
        x0, x1, y0, y1, alpha.data_ptr(),
        torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"overlay_blend_u8 launch failed: cudaError {err}")
    overlay_blend.launches += 1
    return out


overlay_blend.launches = 0
