"""The reference of a ``convert_filter`` configuration: a 4:2:0 or RGB
source -> vfconvertscale at identity size (the Metal sampler, the YUV
matrix, an RGBA8 render target) -> vfvideofilter's brightness, contrast
and saturation (an RGBA8 render target)."""

from __future__ import annotations

from vfbench.reference import LUMA


def frame(r, ref: dict, frames: dict, values: dict):
    (name, src), = ref["sources"].items()
    out = ref["output"]
    if (src["width"], src["height"]) != (out["width"], out["height"]):
        raise ValueError("reference: convert_filter scales nothing")
    chans = r.source_rgba(frames[name], src["format"], src["width"],
                          src["height"])
    q = [r.quant(c) for c in chans]  # vfconvertscale's RGBA8 output
    rgb = [r.dequant(c) for c in q[:3]]
    alpha = r.dequant(q[3])
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
    return r.host_layout([r.quant(x) for x in rgb + [alpha]], out["format"])
