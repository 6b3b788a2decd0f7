"""Videofilter math: the fused color-adjustment chain, the 3D-LUT lookup and
the sharpness blur (port of ``tpuvf.kernels.filter``: the canonical
functions, none of its TPU layout variants).

A translation of applyColorAdjustments in the reference
(src/videofilter/metalvideofilter_shaders.h:88-155): brightness -> contrast ->
saturation (folded into one affine, as in tpuvf) -> hue (HSV rotate, gated
|hue|>0.001) -> gamma -> sepia -> invert -> chroma key -> vignette -> film
grain -> clamp.  Plain PyTorch ops on float32 tensors: the CPU path, and the
plain versions that the card's kernels are held against (the chain runs on
the card inside K2, ``kernels/emit.py``; the LUT lookup inside K3,
``kernels/lut.py``).

Traced parameters arrive as 0-dim float32 tensors, so per-frame scalar
arithmetic (the b/c/s fold coefficients) rounds in float32 exactly as tpuvf's
traced scalars do; Python doubles would round differently and flip
knife-edge pixels.  Divisions by constants use float32 tensors or values
precomputed in numpy: PyTorch on CUDA divides by a Python scalar as a
multiply by its reciprocal, which rounds differently.

The blur/unsharp stage stays plain torch on every device (its hand kernel is
queued in ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

BLUR_WEIGHTS = np.array(
    [0.028532, 0.067234, 0.124009, 0.179044, 0.20236,
     0.179044, 0.124009, 0.067234, 0.028532],
    np.float32,
)

REC709_LUMA = np.array([0.2126, 0.7152, 0.0722], np.float32)
SEPIA = np.array(
    [[0.393, 0.769, 0.189],
     [0.349, 0.686, 0.168],
     [0.272, 0.534, 0.131]],
    np.float32,
)

GATES = ("hue", "gamma", "sepia", "invert", "chroma_key", "vignette", "noise")


def _f32(x) -> float:
    """A Python float holding the float32 rounding of x."""
    return float(np.float32(x))


def plan_coords(width: int, height: int, device, rows=None) -> dict:
    """Pixel-position fields of a (height, width) frame, in float32 exactly
    as tpuvf computes them (vignette texcoords, grain pixel centers), plus
    the 2*pi divisor of the hue rotation, on `device`.  `rows`: the float32
    frame rows to compute the row fields at (a row band's,
    ``parallel.bands.global_rows``), by default every row."""
    x = np.arange(width, dtype=np.float32)
    y = np.arange(height, dtype=np.float32) if rows is None else rows

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return {
        "tx": put((x + 0.5) / np.float32(width))[None, :],
        "ty": put((y + 0.5) / np.float32(height))[:, None],
        "px": put(x + 0.5)[None, :],
        "py": put(y + 0.5)[:, None],
        "two_pi": torch.tensor(_f32(2.0 * np.pi), dtype=torch.float32,
                               device=device),
    }


def _fract(x):
    return x - torch.floor(x)


def _smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def hash12(px, py, frame_index):
    """MSL hash12 (h:63-67): screen-space white noise varying per frame.
    px/py are pixel-center coordinates (x+0.5, y+0.5); frame_index an integer
    tensor."""
    fi = frame_index.to(torch.float32) * _f32(0.00137)
    p3x = _fract(px * _f32(0.1031) + fi)
    p3y = _fract(py * _f32(0.1031) + fi)
    p3z = p3x  # p.xyx
    k = _f32(33.33)
    d = p3x * (p3y + k) + p3y * (p3z + k) + p3z * (p3x + k)
    p3x = p3x + d
    p3y = p3y + d
    p3z = p3z + d
    return _fract((p3x + p3y) * p3z)


def rgb_to_hsv(r, g, b):
    """MSL rgbToHsv (h:71-78) translated branch-for-branch."""
    e = _f32(1.0e-10)
    gb = g >= b
    px = torch.where(gb, g, b)
    py = torch.where(gb, b, g)
    pz = torch.where(gb, 0.0, -1.0)
    pw = torch.where(gb, _f32(-1.0 / 3.0), _f32(2.0 / 3.0))
    rp = r >= px
    qx = torch.where(rp, r, px)
    qy = py
    qz = torch.where(rp, pz, pw)
    qw = torch.where(rp, px, r)
    d = qx - torch.minimum(qw, qy)
    h = torch.abs(qz + (qw - qy) / (6.0 * d + e))
    s = d / (qx + e)
    return h, s, qx


def hsv_to_rgb(h, s, v):
    """MSL hsvToRgb (h:80-84)."""
    def channel(offset):
        p = torch.abs(_fract(h + _f32(offset)) * 6.0 - 3.0)
        return v * ((1.0 - s) + s * torch.clamp(p - 1.0, 0.0, 1.0))

    return channel(1.0), channel(2.0 / 3.0), channel(1.0 / 3.0)


def apply_color_adjustments_t(chans, p, frame_index, coords, gates=None):
    """(r, g, b, a) float32 planes -> same, the canonical op order.

    p: dict of 0-dim float32 tensors {brightness, contrast, saturation, hue
    (radians), gamma, sepia, invert, chroma_key_enabled, key_r, key_g,
    key_b, key_tolerance, key_smoothness, vignette, noise}.
    frame_index: integer tensor (the grain hash's frame counter).
    coords: `plan_coords` of the plane geometry.
    gates: static bools {hue, gamma, sepia, invert, chroma_key, vignette,
    noise}; a stage whose gate is off is omitted (identical output — each
    gate mirrors the shader's own uniform branch).
    """
    if gates is None:
        gates = dict.fromkeys(GATES, True)
    r, g, b, alpha = chans

    # Brightness -> Contrast -> Saturation folded into ONE shared-luma
    # affine, as tpuvf does (filter.py:166-189):
    #   out = (c*s)*x + ((1-s)*c)*(L.x) + k0,  k0 = (brightness-0.5)*c + 0.5
    # with the coefficients computed on float32 0-dim tensors.
    c = p["contrast"]
    s = p["saturation"]
    cs_ = c * s
    m = (1.0 - s) * c
    k0 = (p["brightness"] - 0.5) * c + 0.5
    luma = REC709_LUMA.tolist()
    lum0 = luma[0] * r + luma[1] * g + luma[2] * b
    base = m * lum0 + k0
    r = cs_ * r + base
    g = cs_ * g + base
    b = cs_ * b + base

    # Hue rotation — gated exactly like the uniform branch (|hue| > 0.001)
    if gates["hue"]:
        do_hue = torch.abs(p["hue"]) > 0.001
        hh, hs, hv = rgb_to_hsv(torch.clamp(r, 0.0, 1.0),
                                torch.clamp(g, 0.0, 1.0),
                                torch.clamp(b, 0.0, 1.0))
        hh = _fract(hh + p["hue"] / coords["two_pi"])
        hr, hg, hb = hsv_to_rgb(hh, hs, hv)
        r = torch.where(do_hue, hr, r)
        g = torch.where(do_hue, hg, g)
        b = torch.where(do_hue, hb, b)

    # Gamma (the shader always pows; pow(clamp(x),1) == clamp(x), so a
    # static gamma==1 reduces to the clamp)
    r = torch.clamp(r, 0.0001, 1.0)
    g = torch.clamp(g, 0.0001, 1.0)
    b = torch.clamp(b, 0.0001, 1.0)
    if gates["gamma"]:
        inv_gamma = 1.0 / p["gamma"]
        r = torch.pow(r, inv_gamma)
        g = torch.pow(g, inv_gamma)
        b = torch.pow(b, inv_gamma)

    if gates["sepia"]:
        do_sepia = p["sepia"] > 0.001
        sep = p["sepia"]
        sm = SEPIA.tolist()
        sr = sm[0][0] * r + sm[0][1] * g + sm[0][2] * b
        sg = sm[1][0] * r + sm[1][1] * g + sm[1][2] * b
        sb = sm[2][0] * r + sm[2][1] * g + sm[2][2] * b
        r = torch.where(do_sepia, r + (sr - r) * sep, r)
        g = torch.where(do_sepia, g + (sg - g) * sep, g)
        b = torch.where(do_sepia, b + (sb - b) * sep, b)

    if gates["invert"]:
        inv = p["invert"] > 0.5
        r = torch.where(inv, 1.0 - r, r)
        g = torch.where(inv, 1.0 - g, g)
        b = torch.where(inv, 1.0 - b, b)

    # Chroma key: alpha *= smoothstep(tol, tol+smooth, distance(rgb, key))
    if gates["chroma_key"]:
        ck = p["chroma_key_enabled"] > 0.5
        dr, dg, db = r - p["key_r"], g - p["key_g"], b - p["key_b"]
        dist = torch.sqrt(dr * dr + dg * dg + db * db)
        mask = _smoothstep(p["key_tolerance"],
                           p["key_tolerance"] + p["key_smoothness"], dist)
        alpha = torch.where(ck, alpha * mask, alpha)

    # Vignette (texcoord-based radial falloff)
    if gates["vignette"]:
        cx = coords["tx"] - 0.5
        cy = coords["ty"] - 0.5
        do_vig = p["vignette"] > 0.001
        vdist = torch.sqrt(cx * cx + cy * cy) * _f32(1.414)
        vig = 1.0 - _smoothstep(0.5, 1.0, vdist) * p["vignette"]
        r = torch.where(do_vig, r * vig, r)
        g = torch.where(do_vig, g * vig, g)
        b = torch.where(do_vig, b * vig, b)

    # Film grain
    if gates["noise"]:
        do_noise = p["noise"] > 0.001
        n = hash12(coords["px"], coords["py"], frame_index)
        n = (n - 0.5) * p["noise"] * 0.5
        r = torch.where(do_noise, r + n, r)
        g = torch.where(do_noise, g + n, g)
        b = torch.where(do_noise, b + n, b)

    if not (gates["sepia"] or gates["noise"]):
        # the gamma-stage clamp bounded r/g/b to [1e-4, 1] and every later
        # active stage preserves [0, 1], so the final clip is a no-op and is
        # elided, as in tpuvf
        return (r, g, b, alpha)
    return (torch.clamp(r, 0.0, 1.0), torch.clamp(g, 0.0, 1.0),
            torch.clamp(b, 0.0, 1.0), alpha)


def pack_lut_corners(lut: np.ndarray) -> np.ndarray:
    """(S, S, S, 3) [b][g][r] table -> corner-packed float32 (S^3, 24).

    Cell (b, g, r) stores its 8 trilinear corners (the +1 neighbours
    clamped at the edges) contiguously, corner k at (b+db, g+dg, r+dr) with
    db, dg, dr = (k>>2)&1, (k>>1)&1, k&1, so the lookup reads one table row
    per pixel.  Always float32: the reference's RGBA32Float storage.
    """
    size = lut.shape[0]
    i0 = np.arange(size)
    i1 = np.minimum(i0 + 1, size - 1)
    packed = np.empty((size, size, size, 8, 3), np.float32)
    for k in range(8):
        db, dg, dr = (k >> 2) & 1, (k >> 1) & 1, k & 1
        bb = i1 if db else i0
        gg = i1 if dg else i0
        rr = i1 if dr else i0
        packed[..., k, :] = lut[bb[:, None, None], gg[None, :, None],
                                rr[None, None, :]]
    return packed.reshape(size ** 3, 24)


def apply_lut_t_plain(chans, table: torch.Tensor, size: int):
    """3D LUT lookup with trilinear filtering (h:188-194): (r, g, b, a)
    float32 planes -> same, alpha passed through.

    table: the float32 (S^3, 24) `pack_lut_corners` table on the planes'
    device.  The texel-space coordinate is rgb*(S-1); one index_select of
    the table rows, then tpuvf's arithmetic in tpuvf's order.
    """
    r, g, b, alpha = chans
    s1 = float(size - 1)

    def axis(x):
        p = x * s1
        fl = torch.floor(p)
        f = p - fl
        # NaN takes cell 0, as XLA's cast and the kernel's fmaxf do (its
        # weights are NaN, so the pixel is NaN whichever cell it reads)
        fl = torch.nan_to_num(fl, nan=0.0)
        return torch.clamp(fl, 0, size - 1).to(torch.int32), [1.0 - f, f]

    r0, w_fr = axis(r)
    g0, w_fg = axis(g)
    b0, w_fb = axis(b)
    cell = (b0 * size + g0) * size + r0
    corners = table.index_select(0, cell.reshape(-1))
    acc = [None, None, None]
    for k in range(8):
        db, dg, dr = (k >> 2) & 1, (k >> 1) & 1, k & 1
        wk = (w_fb[db] * w_fg[dg]) * w_fr[dr]
        for c in range(3):
            t = wk * corners[:, 3 * k + c].reshape(r.shape)
            acc[c] = t if acc[c] is None else acc[c] + t
    return (acc[0], acc[1], acc[2], alpha)


def blur9(img: torch.Tensor, axis: int) -> torch.Tensor:
    """9-tap Gaussian along one axis with edge clamping (blurHorizontal /
    blurVertical, h:265-299), `BLUR_WEIGHTS` in order: tap i of output n
    reads clip(n - 4 + i, 0, N - 1)."""
    axis = axis % img.ndim
    n = img.shape[axis]
    out = None
    for i, w in enumerate(BLUR_WEIGHTS.tolist()):
        idx = torch.clamp(torch.arange(n, device=img.device) + (i - 4),
                          0, n - 1)
        tap = img.index_select(axis, idx) * w
        out = tap if out is None else out + tap
    return out


def unsharp_mask(original: torch.Tensor, blurred: torch.Tensor,
                 amount: torch.Tensor) -> torch.Tensor:
    """unsharpMask (h:302-328) on (..., 4, H, W): amount > 0 sharpens,
    amount < 0 mixes toward the blur; alpha always from the original.
    amount: 0-dim float32 tensor."""
    sharpened = torch.clamp(original + (original - blurred) * amount, 0.0, 1.0)
    mixed = original + (blurred - original) * torch.abs(amount)
    out = torch.where(amount > 0, sharpened, mixed)
    return torch.cat([out[..., :3, :, :], original[..., 3:4, :, :]], dim=-3)
