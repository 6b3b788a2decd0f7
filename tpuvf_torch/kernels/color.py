"""Color-space math: BT.601/BT.709 limited-range YUV<->RGB, quantization
(port of ``tpuvf.kernels.color``).

Constants are tpuvf's float32 tables.  Every coefficient is applied as a
Python float holding the exact float32 value, which PyTorch converts to the
tensor's float32 dtype, so each multiply and add rounds exactly as tpuvf's
float32 expression does.  The expressions keep tpuvf's operand order: float
addition is not associative, and these sums decide knife-edge pixels.
"""

from __future__ import annotations

import numpy as np
import torch

# rows below are the usual R/G/B = f(Y,Cb,Cr) equations; yuv_to_rgb[m][r][c]
# multiplies (y,u,v)
YUV_OFFSET = np.array([16.0 / 255.0, 128.0 / 255.0, 128.0 / 255.0], np.float32)

YUV_TO_RGB = np.array(
    [
        # BT.601 limited range (vfmetalshaders.m:42-47)
        [
            [1.164383, 0.0, 1.596027],
            [1.164383, -0.391762, -0.812968],
            [1.164383, 2.017232, 0.0],
        ],
        # BT.709 limited range (vfmetalshaders.m:50-55)
        [
            [1.164383, 0.0, 1.792741],
            [1.164383, -0.213249, -0.532909],
            [1.164383, 2.112402, 0.0],
        ],
    ],
    np.float32,
)

# rgb->yuv: rows are Y/U/V = f(R,G,B) (vfmetalshaders.m:58-69, columns = R,G,B)
RGB_TO_YUV = np.array(
    [
        [
            [0.256788, 0.504129, 0.097906],
            [-0.148223, -0.290993, 0.439216],
            [0.439216, -0.367788, -0.071427],
        ],
        [
            [0.182586, 0.614231, 0.062007],
            [-0.100644, -0.338572, 0.439216],
            [0.439216, -0.398942, -0.040274],
        ],
    ],
    np.float32,
)

_INV255 = float(np.float32(1.0 / 255.0))


def dequant(x: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [0,1] (Metal Unorm8 read: v * f32(1/255))."""
    return x.to(torch.float32) * _INV255


def as_float(x: torch.Tensor) -> torch.Tensor:
    """`dequant` of uint8 planes; float32 planes (already sampled) as they
    are."""
    return dequant(x) if x.dtype == torch.uint8 else x


def quant(x: torch.Tensor) -> torch.Tensor:
    """float -> uint8 (Metal Unorm8 store: round(clamp(v,0,1)*255)).
    ``torch.round`` rounds half to even, like ``jnp.round``; the clamp keeps
    the cast in range."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def yuv_to_rgb(y, u, v, matrix_index: int):
    """Limited-range YUV -> RGB, clamped to [0,1] (yuvToRGB, m:71-79).

    Inputs are float32 tensors in [0,1] (any matching shapes); matrix_index
    is 0 (BT.601) or 1 (BT.709).  Returns (r, g, b).
    """
    m = YUV_TO_RGB[matrix_index].tolist()
    off = YUV_OFFSET.tolist()
    yo = y - off[0]
    uo = u - off[1]
    vo = v - off[2]
    r = m[0][0] * yo + m[0][1] * uo + m[0][2] * vo
    g = m[1][0] * yo + m[1][1] * uo + m[1][2] * vo
    b = m[2][0] * yo + m[2][1] * uo + m[2][2] * vo
    return (torch.clamp(r, 0.0, 1.0), torch.clamp(g, 0.0, 1.0),
            torch.clamp(b, 0.0, 1.0))


def rgb_to_yuv(r, g, b, matrix_index: int):
    """RGB -> limited-range YUV (+offset), unclamped.

    The output kernels (rgbaToNV12 etc., vfmetalshaders.m:90-168) clamp only
    at the texture write; quant() reproduces that clamp.
    """
    m = RGB_TO_YUV[matrix_index].tolist()
    off = YUV_OFFSET.tolist()
    y = m[0][0] * r + m[0][1] * g + m[0][2] * b + off[0]
    u = m[1][0] * r + m[1][1] * g + m[1][2] * b + off[1]
    v = m[2][0] * r + m[2][1] * g + m[2][2] * b + off[2]
    return y, u, v


def rgb_to_chroma_downsampled(r, g, b, matrix_index: int, out_cw: int, out_ch: int):
    """RGB (H, W) -> (u, v) at 4:2:0 half resolution.

    Reproduces rgbaToNV12's 2x2 box average with edge clamping for odd
    dimensions (vfmetalshaders.m:104-124): the RGB values of each 2x2 block
    (duplicating the last row/column when H or W is odd) are averaged *before*
    the RGB->YUV matrix is applied.  Row pairs first, then column pairs, as
    in tpuvf.
    """
    h, w = r.shape[-2], r.shape[-1]
    pad_h, pad_w = 2 * out_ch - h, 2 * out_cw - w

    def avg(x):
        if pad_h:
            x = torch.cat([x, x[..., -1:, :]], dim=-2)
        if pad_w:
            x = torch.cat([x, x[..., -1:]], dim=-1)
        rows = (x[..., 0::2, :] + x[..., 1::2, :]) * 0.5
        return (rows[..., 0::2] + rows[..., 1::2]) * 0.5

    ra, ga, ba = avg(r), avg(g), avg(b)
    _, u, v = rgb_to_yuv(ra, ga, ba, matrix_index)
    return u, v
