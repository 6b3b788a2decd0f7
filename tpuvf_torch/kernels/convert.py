"""Input sampling and output packing of the canonical path (port of
``tpuvf.kernels.convert``: `plan_plane_sampler`, `plan_rgba_sampler`,
`pack_rgba`, `_pack_yuv_channels`).

`plan_rgba_sampler` is the first half of every element's fragment stage:
sample the input planes at the output grid's texcoords (Metal sampler
semantics).  The second half, RGBA conversion and quantization, is the fused
emit (K2, ``kernels/emit.py``), with `plan_border` giving it the letterbox
border.  tpuvf picks among closed forms (2x stencils, integer
and rational phase forms, letterbox 2x), blockband and dense matmuls and the
Pallas row kernel, each a re-expression of one 2-tap sampling matrix within
1 ulp of the others.  The port keeps only that matrix's taps: every
non-identity axis goes through the 2-tap resample kernels
(``kernels/resample.py``), rows first, then columns, as in tpuvf
(``convert.py:753``); identity axes pass through.

`pack_rgba` is the analog of VfMetalYUVOutput plus the packed-YUV output
kernels: quantized RGBA -> output-format planes, 4:2:0 chroma from a 2x2 box
average and 4:2:2 chroma from a 2-pixel average.  It is tpuvf's
`pack_rgba_t` on the emit's quantized channels, bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvf_torch.core.formats import (
    PACKED_YUV_FORMATS,
    PLANAR_YUV_FORMATS,
    RGB_FORMATS,
    VideoFormat,
    chroma_dims_420,
    chroma_dims_422,
)
from tpuvf_torch.core.spec import FrameSpec
from tpuvf_torch.kernels import color, sample
from tpuvf_torch.kernels.color import as_float, dequant, quant
from tpuvf_torch.kernels.emit import Border
from tpuvf_torch.kernels.resample import (
    band_taps,
    make_col_taps,
    make_taps,
    resample_cols,
    resample_cols_plain,
    resample_rows,
    resample_rows_plain,
)
from tpuvf_torch.kernels.sample import LINEAR, NEAREST
from tpuvf_torch.parallel.bands import plane_rows


def plan_axis_taps(in_size: int, out_size: int, filter: str, scale: float,
                   device, cols: bool = False):
    """Device tap table for one axis (with K1b's band plan for the columns,
    `cols`), or None when the axis is identity (same size, no letterbox:
    identity under both filters)."""
    if scale == 1.0 and out_size == in_size:
        return None
    t = sample.texcoords(out_size, scale)
    mask = sample.coverage_mask(out_size, scale)
    make = make_col_taps if cols else make_taps
    return make(sample.plan_taps(t, in_size, filter, mask), in_size, device)


def plan_plane_sampler(in_w, in_h, out_w, out_h, filter, scale_x, scale_y,
                       device, rows=None):
    """uint8 (..., in_h, in_w) -> (..., out_h, out_w): dequantized and
    resampled (rows, then columns) to float32, or the uint8 planes as they
    are when both axes are identity (the emit dequantizes them).

    With `rows` (out_lo, out_hi, in_lo, in_hi), a row band's sampler: it is
    handed the input rows [in_lo, in_hi) and returns the output rows
    [out_lo, out_hi) (`resample.band_taps`; an identity row axis slices
    them out of the window)."""
    taps_y = plan_axis_taps(in_h, out_h, filter, scale_y, device)
    taps_x = plan_axis_taps(in_w, out_w, filter, scale_x, device, cols=True)
    crop = None
    if rows is not None:
        out_lo, out_hi, in_lo, in_hi = rows
        if taps_y is not None:
            taps_y = band_taps(taps_y, out_lo, out_hi, in_lo, in_hi - in_lo)
        elif (out_lo, out_hi) != (in_lo, in_hi):
            crop = (out_lo - in_lo, out_hi - in_lo)

    def run(img: torch.Tensor) -> torch.Tensor:
        if crop is not None:
            img = img[..., crop[0]:crop[1], :].contiguous()
        if taps_y is None and taps_x is None:
            return img
        img = dequant(img)
        if taps_y is not None:
            img = resample_rows(img, taps_y)
        if taps_x is not None:
            img = resample_cols(img, taps_x)
        return img

    return run


def plan_texcoord_sampler(in_w: int, in_h: int, t_rows, t_cols, device,
                          transpose: bool = False):
    """uint8 (..., in_h, in_w) -> float32 (..., len(t_rows), len(t_cols)):
    the plane sampled LINEAR at arbitrary per-axis texcoords (vftransform's
    `sample.sample_matrix(src_u / src_v, size, LINEAR)`, clamp to edge),
    rows through K1, then columns through K1b.  With `transpose` the plane is
    transposed first (the anti-diagonal methods), so `t_rows` samples its
    width and `t_cols` its height.  Descending texcoords (flipped axes) need
    nothing special: each output's taps are read off its own matrix row."""
    rows_in, cols_in = (in_w, in_h) if transpose else (in_h, in_w)
    taps_y = make_taps(sample.plan_taps(t_rows, rows_in, LINEAR), rows_in,
                       device)
    taps_x = make_col_taps(sample.plan_taps(t_cols, cols_in, LINEAR), cols_in,
                           device)

    def run(img: torch.Tensor) -> torch.Tensor:
        if transpose:
            img = img.transpose(-1, -2).contiguous()
        return resample_cols(resample_rows(dequant(img), taps_y), taps_x)

    return run


def plan_rgba_sampler(
    in_spec: FrameSpec,
    out_w: int,
    out_h: int,
    device,
    filter: str = LINEAR,
    scale_x: float = 1.0,
    scale_y: float = 1.0,
    rows=None,
):
    """-> run(planes) returning the emit's source planes at the output grid
    (``emit.emit``): {"rgba": (4, out_h, out_w)}, or {"y", "u", "v"} with
    float32 U and V; RGBA and luma stay uint8 where the sampler is identity.

    RGB inputs resample the (4, H, W) stack in one launch per axis; 4:2:0
    inputs resample luma, then U and V stacked, one launch per axis each.
    With `rows` (out_lo, out_hi, in_lo, in_hi), in frame rows, a row band's
    sampler (`plan_plane_sampler`): each plane is handed its rows of the
    input frame rows [in_lo, in_hi) and returns the output rows
    [out_lo, out_hi).
    """
    fmt = in_spec.format
    if fmt in PACKED_YUV_FORMATS:
        filter = NEAREST  # packed inputs always decode with nearest

    def plane(pw, ph):
        band = None
        if rows is not None:
            band = (rows[0], rows[1]) + plane_rows(rows[2], rows[3], ph,
                                                   in_spec.height)
        return plan_plane_sampler(pw, ph, out_w, out_h, filter, scale_x,
                                  scale_y, device, band)

    if fmt in RGB_FORMATS:
        run_rgba = plane(in_spec.width, in_spec.height)
    else:
        if fmt in PLANAR_YUV_FORMATS:
            cw, ch = chroma_dims_420(in_spec.width, in_spec.height)
        else:
            cw, ch = chroma_dims_422(in_spec.width, in_spec.height)
        run_y = plane(in_spec.width, in_spec.height)
        run_c = plane(cw, ch)

    def run(planes):
        if fmt in RGB_FORMATS:
            return {"rgba": run_rgba(planes["rgba"])}
        uv = as_float(run_c(torch.stack((planes["u"], planes["v"]), -3)))
        return {"y": run_y(planes["y"]), "u": uv[..., 0, :, :],
                "v": uv[..., 1, :, :]}

    return run


def phase_capable(in_spec: FrameSpec, out_spec: FrameSpec) -> bool:
    """tpuvf's ``_phase_capable`` of vfvideofilter, vfdeinterlace and
    vfoverlay, which their row-sharding predicates read: the format kept,
    and RGB of even width or 4:2:0 of even width and height
    (``can_split_420`` at identity geometry, ``tpuvf/kernels/convert.py:
    857-867``)."""
    if out_spec.format != in_spec.format:
        return False
    if in_spec.format in RGB_FORMATS:
        return in_spec.width % 2 == 0
    return (in_spec.format in PLANAR_YUV_FORMATS
            and in_spec.width % 2 == 0 and in_spec.height % 2 == 0)


def plan_chroma_taps(in_spec: FrameSpec, device, filter: str = LINEAR,
                     rows=None):
    """-> (rows, cols): the 2-tap tables that bring a 4:2:0 input's chroma
    planes to its own luma grid at scale 1, None for an identity axis: the
    tables `plan_rgba_sampler`'s K1 and K1b launches read (without K1b's band
    plan).  The fused routes of K5 and K6 sample each pixel's chroma through
    them, rows first, then columns.  With `rows` (lo, hi), a row band's
    window: the luma rows [lo, hi) from the chroma rows under them
    (`resample.band_taps`)."""
    if in_spec.format not in PLANAR_YUV_FORMATS:
        raise ValueError(f"plan_chroma_taps: {in_spec.format} is not 4:2:0")
    cw, ch = chroma_dims_420(in_spec.width, in_spec.height)
    taps_y = plan_axis_taps(ch, in_spec.height, filter, 1.0, device)
    if rows is not None and taps_y is not None:
        c_lo, c_hi = plane_rows(rows[0], rows[1], ch, in_spec.height)
        taps_y = band_taps(taps_y, rows[0], rows[1], c_lo, c_hi - c_lo)
    return taps_y, plan_axis_taps(cw, in_spec.width, filter, 1.0, device)


def check_chroma_taps(taps, chroma, luma, device, name: str) -> None:
    """`taps` (rows, cols), as `plan_chroma_taps` makes them, must bring the
    (ch, cw) chroma planes to the (H, W) luma grid on `device`, with None
    only for an identity axis; a fused route's wrapper checks them before its
    kernel reads them."""
    if len(taps) != 2:
        raise ValueError(f"{name}: taps must be (rows, cols)")
    for t, n_in, n_out in zip(taps, chroma, luma):
        if t is None:
            if n_in != n_out:
                raise ValueError(f"{name}: an identity axis needs equal "
                                 f"sizes, got {n_in} -> {n_out}")
            continue
        if t.in_size != n_in or t.out_size != n_out:
            raise ValueError(f"{name}: taps map {t.in_size} -> "
                             f"{t.out_size}, the planes {n_in} -> {n_out}")
        if any(x.device != device or not x.is_contiguous() for x in t[:4]):
            raise ValueError(f"{name}: taps must be contiguous on {device}")


def chroma_taps_ptrs(taps) -> list:
    """The 8 chroma tap pointers a fused route's kernel takes: the rows' i0,
    i1, w0, w1, then the columns'; None (null) for an identity axis."""
    ptrs = []
    for t in taps:
        ptrs += [None] * 4 if t is None else [x.data_ptr() for x in t[:4]]
    return ptrs


def sample_yuv420_plain(planes: dict, taps) -> dict:
    """4:2:0 uint8 planes -> the emit's source at the luma grid, {"y" uint8,
    "u", "v" float32}, with the plain resamplers and `plan_chroma_taps`'
    tables: what `plan_rgba_sampler` computes at scale 1, in plain parts."""
    rows, cols = taps
    uv = dequant(torch.stack((planes["u"], planes["v"]), -3))
    if rows is not None:
        uv = resample_rows_plain(uv, rows)
    if cols is not None:
        uv = resample_cols_plain(uv, cols)
    return {"y": planes["y"], "u": uv[..., 0, :, :], "v": uv[..., 1, :, :]}


def plan_border(out_w: int, out_h: int, scale_x: float, scale_y: float,
                color_rgba, device, rows=None) -> Border | None:
    """The letterbox border of an output grid (`color_rgba`: r, g, b, a
    floats), or None when there is no border or the quad covers the
    grid.  With `rows` (lo, hi), the frame's border on the output rows
    [lo, hi) of a row band."""
    if color_rgba is None:
        return None
    mx = sample.coverage_mask(out_w, scale_x)
    my = sample.coverage_mask(out_h, scale_y)
    if mx.all() and my.all():
        return None
    if rows is not None:
        my = my[rows[0]:rows[1]]
    return Border(torch.from_numpy(np.ascontiguousarray(my)).to(device),
                  torch.from_numpy(mx).to(device),
                  tuple(np.asarray(color_rgba, np.float32).tolist()))


def pack_rgba(rgba_q: torch.Tensor, out_format: VideoFormat,
              matrix_index: int) -> dict:
    """Quantized RGBA (..., 4, H, W) uint8 -> output planes dict (uint8).

    Chroma averaging happens on dequantized texel values, exactly like
    rgbaToNV12/rgbaToI420 (vfmetalshaders.m:90-168) and rgbaToUYVY/rgbaToYUY2
    (metalconvertscale_shaders.h:202-269).
    """
    if out_format in RGB_FORMATS:
        return {"rgba": rgba_q}
    rgbaf = dequant(rgba_q)
    r, g, b = rgbaf[..., 0, :, :], rgbaf[..., 1, :, :], rgbaf[..., 2, :, :]
    return _pack_yuv_channels(r, g, b, out_format, matrix_index)


def _pack_yuv_channels(r, g, b, out_format, matrix_index):
    h, w = r.shape[-2], r.shape[-1]
    yf, uf, vf = color.rgb_to_yuv(r, g, b, matrix_index)
    if out_format in PLANAR_YUV_FORMATS:
        cw, ch = chroma_dims_420(w, h)
        u, v = color.rgb_to_chroma_downsampled(r, g, b, matrix_index, cw, ch)
        return {"y": quant(yf), "u": quant(u), "v": quant(v)}
    if out_format in PACKED_YUV_FORMATS:
        # one output macro-pixel per 2 source pixels; chroma = mean of both
        # pixels' U/V after the RGB->YUV matrix (shaders h:202-269)
        u0, u1 = uf[..., 0::2], uf[..., 1::2]
        v0, v1 = vf[..., 0::2], vf[..., 1::2]
        return {
            "y": quant(yf),
            "u": quant((u0 + u1) * 0.5),
            "v": quant((v0 + v1) * 0.5),
        }
    raise ValueError(f"unknown output format {out_format}")
