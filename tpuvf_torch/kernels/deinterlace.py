"""K5: vfdeinterlace's whole body (port of ``tpuvf.kernels.deinterlace``,
the canonical full-frame forms `bob_t`, `weave_t` and `greedyh_t` with the
element's first-frame fallback, and of the element's texture and output
pack, ``tpuvf/elements/deinterlace.py:441-480``).

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

`deinterlace_frame` runs the element's body on the input's planes: the
texture (an RGB input's planes as they are; for a 4:2:0 input
``quant(yuv_to_rgb(...))`` with the chroma sampled NEAREST), the field
logic, and the output format's planes (RGBA8, or ``convert.pack_rgba`` to
4:2:0).  It returns the texture as well, the next frame's ``prev``, for
weave and greedy-H.  On CUDA planes it launches one hand-written kernel
(``csrc/deinterlace.cu``) on the current stream: ``deinterlace_u8`` for RGB
in, ``deinterlace_yuv420_u8`` for 4:2:0 in, which computes the texture in
registers and writes it out for the next frame.  On CPU planes it calls
`deinterlace_frame_plain`, the element's former composition of plain parts
(the plain sampler, ``emit_plain``, `deinterlace_plain`,
``convert.pack_rgba``).  `deinterlace` and `deinterlace_plain` are its RGB
route with RGBA8 out.  There is no other path: a CUDA launch that fails
raises.  The kernels are bitwise equal to the plain version (no FMA
contraction on either side).

The wrapper counts its kernel launches in ``deinterlace_frame.launches``.
"""

from __future__ import annotations

import torch

from tpuvf_torch.core.formats import (
    PLANAR_YUV_FORMATS,
    RGB_FORMATS,
    VideoFormat,
    chroma_dims_420,
)
from tpuvf_torch.kernels import _build, convert
from tpuvf_torch.kernels.color import dequant, quant
from tpuvf_torch.kernels.emit import emit_plain

# vfdeinterlace's method enum (csrc/deinterlace.cu enum Method)
METHOD_BOB, METHOD_WEAVE, METHOD_LINEAR, METHOD_GREEDYH = 0, 1, 2, 3


def _stateful(method: int) -> bool:
    """Whether the method carries the texture to the next frame."""
    return method in (METHOD_WEAVE, METHOD_GREEDYH)


def _reads_prev(method: int, has_prev: bool) -> bool:
    return has_prev and _stateful(method)


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


def deinterlace_frame_plain(planes: dict, prev: torch.Tensor | None,
                            method: int, tff: bool, has_prev: bool,
                            threshold: torch.Tensor, taps, matrix_in: int,
                            out_format: VideoFormat,
                            matrix_out: int) -> tuple:
    """The plain composition of `deinterlace_frame` (module doc) -> (output
    planes, the input's texture for weave and greedy-H, else None)."""
    cur = (planes["rgba"] if "rgba" in planes
           else emit_plain(convert.sample_yuv420_plain(planes, taps),
                           matrix_in))
    out = deinterlace_plain(cur, prev, method, tff, has_prev, threshold)
    return (convert.pack_rgba(out, out_format, matrix_out),
            cur if _stateful(method) else None)


# -- the kernel wrapper ------------------------------------------------------


def _input(planes, taps):
    """-> (height, width, device) of the input planes, after checking them:
    {"rgba": (4, H, W)} or 4:2:0 {"y", "u", "v"}, uint8, on one device."""
    if "rgba" in planes:
        cur = planes["rgba"]
        if cur.dtype != torch.uint8 or cur.dim() != 3 or cur.shape[0] != 4:
            raise ValueError(f"deinterlace: cur must be (4, H, W) uint8, got "
                             f"{cur.dtype}{tuple(cur.shape)}")
        return cur.shape[1], cur.shape[2], cur.device
    y, u, v = planes["y"], planes["u"], planes["v"]
    height, width = y.shape[-2], y.shape[-1]
    chroma = chroma_dims_420(width, height)[::-1]
    if (y.dim() != 2 or tuple(u.shape) != chroma or tuple(v.shape) != chroma
            or any(p.dtype != torch.uint8 for p in (y, u, v))
            or any(p.device != y.device for p in (u, v))):
        raise ValueError(f"deinterlace: 4:2:0 planes must be uint8 (H, W) "
                         f"and two {chroma} on one device, got "
                         f"{tuple(y.shape)}, {tuple(u.shape)}, "
                         f"{tuple(v.shape)}")
    convert.check_chroma_taps(taps, chroma, (height, width), y.device,
                              "deinterlace")
    return height, width, y.device


def _check(planes, prev, method, threshold, taps, out_format, matrix_in,
           matrix_out):
    """-> (height, width, device) after checking what the kernels take."""
    height, width, device = _input(planes, taps)
    if method not in (METHOD_BOB, METHOD_WEAVE, METHOD_LINEAR,
                      METHOD_GREEDYH):
        raise ValueError(f"deinterlace: unknown method {method}")
    if prev is not None and (prev.dtype != torch.uint8
                             or tuple(prev.shape) != (4, height, width)
                             or prev.device != device):
        raise ValueError("deinterlace: prev must be a (4, H, W) uint8 tensor "
                         "on the input's device")
    if (threshold.dtype != torch.float32 or threshold.dim() != 0
            or threshold.device != device):
        raise ValueError("deinterlace: threshold must be a 0-dim float32 "
                         "tensor on the input's device")
    if out_format not in RGB_FORMATS + PLANAR_YUV_FORMATS:
        raise ValueError(f"deinterlace: unsupported output {out_format}")
    if matrix_in not in (0, 1) or matrix_out not in (0, 1):
        raise ValueError(f"deinterlace: matrices must be 0 or 1, got "
                         f"{matrix_in}, {matrix_out}")
    return height, width, device


def _ptr(t: torch.Tensor, name: str) -> int:
    if not t.is_contiguous():
        raise ValueError(f"deinterlace: the kernel needs a contiguous {name}")
    return t.data_ptr()


def deinterlace_frame(planes: dict, prev: torch.Tensor | None, method: int,
                      tff: bool, has_prev: bool, threshold: torch.Tensor,
                      taps, matrix_in: int, out_format: VideoFormat,
                      matrix_out: int) -> tuple:
    """K5: `deinterlace_frame_plain` in one launch on the card -> (output
    planes, texture or None).  `planes` is {"rgba"} or 4:2:0 {"y", "u",
    "v"}, whose `taps` are ``convert.plan_chroma_taps(in_spec, device,
    NEAREST)`` (None for RGB); `out_format` is RGB or 4:2:0.  `tff` and
    `has_prev` are host values, so no frame waits for the device; the
    threshold stays on the device and the kernel reads it there."""
    height, width, device = _check(planes, prev, method, threshold, taps,
                                   out_format, matrix_in, matrix_out)
    reads_prev = _reads_prev(method, has_prev)
    if reads_prev and prev is None:
        raise ValueError("deinterlace: prev is needed: the method reads the "
                         "previous frame")
    if device.type == "cpu":
        return deinterlace_frame_plain(planes, prev, method, tff, has_prev,
                                       threshold, taps, matrix_in,
                                       out_format, matrix_out)
    if device.type != "cuda":
        raise ValueError(f"deinterlace: unsupported device {device}")
    rgb_in = "rgba" in planes
    if out_format in RGB_FORMATS:
        out = {"rgba": torch.empty((4, height, width), dtype=torch.uint8,
                                   device=device)}
        ptrs = [out["rgba"].data_ptr(), None, None]
    else:
        cw, ch = chroma_dims_420(width, height)
        out = {"y": torch.empty((height, width), dtype=torch.uint8,
                                device=device),
               "u": torch.empty((ch, cw), dtype=torch.uint8, device=device),
               "v": torch.empty((ch, cw), dtype=torch.uint8, device=device)}
        ptrs = [out[k].data_ptr() for k in ("y", "u", "v")]
    tex = None
    if _stateful(method):
        tex = planes["rgba"] if rgb_in else torch.empty(
            (4, height, width), dtype=torch.uint8, device=device)
    if height * width == 0:
        return out, tex
    prev_ptr = _ptr(prev, "prev") if reads_prev else None
    common = (threshold.data_ptr(), height, width, method, int(bool(tff)))
    stream = torch.cuda.current_stream(device).cuda_stream
    lib = _build.load()
    if rgb_in:
        fn = lib.deinterlace_u8
        err = fn(_ptr(planes["rgba"], "rgba"), prev_ptr, *ptrs, *common,
                 matrix_out, stream)
    else:
        fn = lib.deinterlace_yuv420_u8
        err = fn(*(_ptr(planes[k], k) for k in ("y", "u", "v")),
                 *convert.chroma_taps_ptrs(taps), prev_ptr, *ptrs,
                 None if tex is None else tex.data_ptr(), *common, matrix_in,
                 matrix_out, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {err}")
    deinterlace_frame.launches += 1
    return out, tex


def route(planes: dict, prev: torch.Tensor | None) -> tuple:
    """(columns a thread, vector path) of `deinterlace_frame`'s launch: the
    vector path, 16 columns (RGB in) or 4 (4:2:0 in), where the width is a
    multiple of them and the input planes and `prev` start on that many
    bytes (the outputs the wrapper allocates always do), else the scalar
    path, byte by byte, 4 columns.  The rule of ``launch_route`` in
    csrc/deinterlace.cu, for reports."""
    cols = 16 if "rgba" in planes else 4
    x = planes["rgba"] if "rgba" in planes else planes["y"]
    vec = x.shape[-1] % cols == 0 and all(
        t.data_ptr() % cols == 0 for t in (x, prev) if t is not None)
    return (cols, True) if vec else (4, False)


def deinterlace(cur: torch.Tensor, prev: torch.Tensor | None, method: int,
                tff: bool, has_prev: bool,
                threshold: torch.Tensor) -> torch.Tensor:
    """K5's RGB route with RGBA8 out: `deinterlace_plain` in one launch on
    the card (through `deinterlace_frame`, which counts it)."""
    out, _ = deinterlace_frame({"rgba": cur}, prev, method, tff, has_prev,
                               threshold, None, 0, VideoFormat.RGBA, 0)
    return out["rgba"]


deinterlace_frame.launches = 0
