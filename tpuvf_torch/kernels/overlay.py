"""K6: vfoverlay's whole body, and the host resample of the overlay image
(port of ``tpuvf.elements.overlay``: `fold_draw_config` and the canonical
`make_process_linked` body).

`overlay_rect` runs at build time on the host: it resamples the
premultiplied overlay image onto the frame grid with the linear sampler and
keeps the covered rect.  It is tpuvf's numpy expression as it stands (a
float32 matmul over the full frame; a rect-only product is not guaranteed to
give the same bits from BLAS).

Per frame, on the frame's float32 RGB (the dequantized uint8 planes of an
RGB input; the emit's unquantized ``yuv_to_rgb`` of a 4:2:0 input, its
chroma sampled LINEAR to the luma grid)::

    inside the rect, c < 3:  v_c = v_c * (1 - a) + ov_c * a,  a = ov_3 * alpha
    everywhere:              q = quant(v)      (alpha channel unblended)
    out = q, or convert.pack_rgba(q) to 4:2:0 with the output matrix

Outside the rect tpuvf pads the overlay with zeros, which makes its blend an
exact identity there; the kernel skips it.

`overlay_frame` runs it on the input's planes, {"rgba"} or {"y", "u", "v"}
(NV12 and I420 alike), and returns the output's planes of the same kind.  On
CUDA planes it launches one hand-written kernel (``csrc/overlay.cu``) on the
current stream: ``overlay_blend_u8`` for RGB, ``overlay_yuv420_u8`` for
4:2:0, which samples the chroma through `convert.plan_chroma_taps`' tables
and packs the output itself.  On CPU planes it calls `overlay_frame_plain`,
the element's former composition of plain parts (the plain sampler,
``emit_plain`` to float32, `overlay_blend_plain`, ``convert.pack_rgba``).
There is no other path: a CUDA launch that fails raises.  The kernels are
bitwise equal to the plain version (no FMA contraction on either side).

The wrapper counts its kernel launches in ``overlay_frame.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvf_torch.core.formats import VideoFormat
from tpuvf_torch.kernels import _build, convert, sample
from tpuvf_torch.kernels.color import as_float, quant
from tpuvf_torch.kernels.emit import emit_plain


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


def band_rect(rect, planes: np.ndarray, lo: int, hi: int):
    """The frame's `overlay_rect` (rect, planes) on its rows [lo, hi): the
    rect clipped to them and moved to a window starting at row `lo`, the
    planes' rows inside it (tpuvf slices its padded rect planes per shard,
    ``tpuvf/elements/overlay.py:601-604``)."""
    x0, x1, y0, y1 = rect
    a, b = max(y0, lo), min(y1, hi)
    if b <= a or _empty(rect):
        return (0, 0, 0, 0), np.zeros((4, 0, 0), np.float32)
    return ((x0, x1, a - lo, b - lo),
            np.ascontiguousarray(planes[:, a - y0:b - y0, :]))


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


def overlay_frame_plain(planes: dict, taps, rect, ov: torch.Tensor,
                        alpha: torch.Tensor, matrix_in: int,
                        matrix_out: int) -> dict:
    """The plain composition of `overlay_frame` (module doc): RGB planes
    blend as they are; 4:2:0 planes go through the sampler (`taps`,
    ``convert.plan_chroma_taps``') and ``emit_plain`` to float32 first, and
    pack back to 4:2:0 after."""
    if "rgba" in planes:
        return {"rgba": overlay_blend_plain(planes["rgba"], rect, ov, alpha)}
    src = emit_plain(convert.sample_yuv420_plain(planes, taps), matrix_in,
                     out_float=True)
    return convert.pack_rgba(overlay_blend_plain(src, rect, ov, alpha),
                             VideoFormat.I420, matrix_out)


# -- the kernel wrapper ------------------------------------------------------


def _check(planes, taps, rect, ov, alpha, matrix_in, matrix_out):
    """-> (height, width, device) after checking what the kernels take."""
    if "rgba" in planes:
        src = planes["rgba"]
        if src.dim() != 3 or src.shape[0] != 4 or src.dtype != torch.uint8:
            raise ValueError(f"overlay_frame: rgba must be (4, H, W) uint8, "
                             f"got {src.dtype}{tuple(src.shape)}")
        height, width = src.shape[1], src.shape[2]
    else:
        y, u, v = planes["y"], planes["u"], planes["v"]
        height, width = y.shape[-2], y.shape[-1]
        chroma = (height + 1) // 2, (width + 1) // 2
        if (y.dim() != 2 or tuple(u.shape) != chroma
                or tuple(v.shape) != chroma):
            raise ValueError(f"overlay_frame: 4:2:0 planes must be (H, W) "
                             f"and two {chroma}, got {tuple(y.shape)}, "
                             f"{tuple(u.shape)}, {tuple(v.shape)}")
        if any(p.dtype != torch.uint8 for p in (y, u, v)):
            raise ValueError("overlay_frame: the planes must be uint8")
        if any(p.device != y.device for p in (u, v)):
            raise ValueError("overlay_frame: the planes lie on two devices")
        convert.check_chroma_taps(taps, chroma, (height, width), y.device,
                                  "overlay_frame")
        src = y
    if matrix_in not in (0, 1) or matrix_out not in (0, 1):
        raise ValueError(f"overlay_frame: matrices must be 0 or 1, got "
                         f"{matrix_in}, {matrix_out}")
    if (alpha.dtype != torch.float32 or alpha.dim() != 0
            or alpha.device != src.device):
        raise ValueError("overlay_frame: alpha must be a 0-dim float32 tensor "
                         "on the planes' device")
    if not _empty(rect):
        x0, x1, y0, y1 = rect
        if not (0 <= x0 and 0 <= y0 and x1 <= width and y1 <= height):
            raise ValueError(f"overlay_frame: rect {rect} leaves the "
                             f"{width}x{height} frame")
        if (ov.dtype != torch.float32
                or tuple(ov.shape) != (4, y1 - y0, x1 - x0)
                or ov.device != src.device):
            raise ValueError(f"overlay_frame: ov must be float32 (4, "
                             f"{y1 - y0}, {x1 - x0}) on the planes' device, "
                             f"got {ov.dtype}{tuple(ov.shape)} on "
                             f"{ov.device}")
    return height, width, src.device


def _ptr(t: torch.Tensor, name: str) -> int:
    if not t.is_contiguous():
        raise ValueError(f"overlay_frame: the kernel needs a contiguous "
                         f"{name}")
    return t.data_ptr()


def route(planes: dict) -> tuple:
    """(columns a thread, vector path) of `overlay_frame`'s launch: the
    vector path, 16 columns (RGB) or 4 (4:2:0), where the width is a
    multiple of them and the input's RGB or Y plane starts on that many
    bytes (the outputs the wrapper allocates always do), else the scalar
    path, byte by byte, 1 column (RGB) or 4 (4:2:0).  The launchers' rule in
    csrc/overlay.cu, for reports."""
    rgb = "rgba" in planes
    x = planes["rgba"] if rgb else planes["y"]
    cols = 16 if rgb else 4
    if x.shape[-1] % cols == 0 and x.data_ptr() % cols == 0:
        return cols, True
    return (1 if rgb else 4), False


def overlay_frame(planes: dict, taps, rect, ov: torch.Tensor,
                  alpha: torch.Tensor, matrix_in: int,
                  matrix_out: int) -> dict:
    """K6: `overlay_frame_plain` in one launch on the card; `alpha` stays on
    the device and the kernel reads it there.  `taps` is
    ``convert.plan_chroma_taps(in_spec, device)`` for 4:2:0 planes (LINEAR),
    None for RGB planes."""
    height, width, device = _check(planes, taps, rect, ov, alpha, matrix_in,
                                   matrix_out)
    if device.type == "cpu":
        return overlay_frame_plain(planes, taps, rect, ov, alpha, matrix_in,
                                   matrix_out)
    if device.type != "cuda":
        raise ValueError(f"overlay_frame: unsupported device {device}")
    empty = _empty(rect)
    x0, x1, y0, y1 = (0, 0, 0, 0) if empty else rect
    ov_ptr = None if empty else _ptr(ov, "overlay")
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _build.load()
    if "rgba" in planes:
        src = planes["rgba"]
        out = {"rgba": torch.empty_like(src)}
        if src.numel() == 0:
            return out
        fn = lib.overlay_blend_u8
        err = fn(_ptr(src, "rgba"), out["rgba"].data_ptr(), height, width,
                 ov_ptr, x0, x1, y0, y1, alpha.data_ptr(), stream)
    else:
        out = {k: torch.empty_like(planes[k]) for k in ("y", "u", "v")}
        if out["y"].numel() == 0:
            return out
        fn = lib.overlay_yuv420_u8
        err = fn(*(_ptr(planes[k], k) for k in ("y", "u", "v")),
                 *convert.chroma_taps_ptrs(taps),
                 *(out[k].data_ptr() for k in ("y", "u", "v")), height,
                 width, ov_ptr, x0, x1, y0, y1, alpha.data_ptr(), matrix_in,
                 matrix_out, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")
    overlay_frame.launches += 1
    return out


overlay_frame.launches = 0
