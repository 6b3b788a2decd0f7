"""The reference of a ``convert_scale_filter`` configuration: a 4:2:0
source -> vfconvertscale to another size (the Metal sampler on every plane,
the YUV matrix, an RGBA8 render target) -> vfvideofilter's brightness,
contrast and saturation (an RGBA8 render target).

Each output pixel samples Y, U and V with the Metal linear sampler
(half-texel centres, clamp to edge) at the output grid's centres, converts
with the source's matrix (GStreamer's default colorimetry for the source's
height) and clamps, and is quantized to the RGBA8 target; the filter then
reads those bytes back, as ``convert_filter.py`` does.

Where the program departs from the shader: the shader's hardware sampler
filters each plane in one step, its fractions in fixed point; the program
samples in two separable float32 passes, rows first and then columns, its
weights the sampler's fractions in float32 (``kernels/sample.py``).  The
reference weighs in float32 too, but in ``Reference.bilinear``'s order
(each row's two columns, then the two rows), so the two differ only by the
rounding of float32 sums, which can move a byte by 1 after a quantization."""

from __future__ import annotations

import numpy as np
import torch

from vfbench.reference import LUMA, matrix_for


def frame(r, ref: dict, frames: dict, values: dict):
    (name, src), = ref["sources"].items()
    out = ref["output"]
    if src["format"] not in ("NV12", "I420"):
        raise ValueError("reference: convert_scale_filter takes 4:2:0 in")
    w, h = out["width"], out["height"]
    planes = {k: torch.as_tensor(np.asarray(p))
              for k, p in frames[name].items()}
    if src["format"] == "NV12":
        planes["u"], planes["v"] = planes["uv"][:, 0::2], planes["uv"][:, 1::2]
    y, u, v = (r.bilinear(r.dequant(planes[k]), w, h) for k in "yuv")
    rgb = r.yuv_to_rgb(y, u, v, matrix_for(src["height"]))
    # vfconvertscale's RGBA8 output, read back by the filter
    rgb = [r.dequant(r.quant(c)) for c in rgb]
    f = dict(ref["filter"], **values)
    b, c, s = (r.const(f["brightness"]), r.const(f["contrast"]),
               r.const(f["saturation"]))
    half = r.const(0.5)
    rgb = [x + b for x in rgb]
    rgb = [(x - half) * c + half for x in rgb]
    lum = (r.const(LUMA[0]) * rgb[0] + r.const(LUMA[1]) * rgb[1]
           + r.const(LUMA[2]) * rgb[2])
    rgb = [lum + (x - lum) * s for x in rgb]
    rgb = [x.clamp(0.0001, 1.0) for x in rgb]  # the shader's gamma clamp
    gamma = float(f.get("gamma", 1.0))
    if gamma != 1.0:
        rgb = [x.pow(r.const(1.0 / gamma)) for x in rgb]
    alpha = torch.full((h, w), 255, dtype=torch.uint8, device=r.device)
    return r.host_layout([r.quant(x) for x in rgb] + [alpha], out["format"])
