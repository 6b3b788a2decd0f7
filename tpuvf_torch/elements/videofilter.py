"""vfvideofilter — the color-adjustment effect chain (port of
``tpuvf.elements.videofilter``, canonical path).

- formats BGRA, RGBA, NV12, I420 (gstvfmetalvideofilter.m:53)
- 15 properties with the reference ranges/defaults (m:67-101, 435-533); the
  controllable color/effect props are traced scalars (0-dim float32 tensors)
- passthrough iff every property is at its default, FLOAT_EQ eps 1e-6
  (m:114-138)
- a per-frame monotonically increasing frameIndex drives the grain hash
  (m:183-205); carried as explicit state with uint32 wrap
- the fused adjustment pass keeps its RGBA8 quantization boundary; `lut-file`
  and non-zero `sharpness` are not ported yet (ROADMAP.md Queue 1: LUT
  and sharpness) and raise NotImplementedError when the pipeline is built.
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvf_torch.core.element import Element
from tpuvf_torch.core.formats import CORE_FORMATS
from tpuvf_torch.core.properties import PropertyDescriptor
from tpuvf_torch.core.registry import register
from tpuvf_torch.core.spec import FrameSpec
from tpuvf_torch.kernels import convert, filter as kfilter

_NOT_PORTED = "(ROADMAP.md Queue 1: LUT and sharpness)"


@register
class VideoFilter(Element):
    ELEMENT_NAME = "vfvideofilter"
    ALIASES = ("vfmetalvideofilter", "videofilter")
    KLASS = "Filter/Effect/Video"
    DESCRIPTION = "Color adjustment, effects, chroma key and 3D LUT in one pass"
    IN_FORMATS = CORE_FORMATS
    OUT_FORMATS = CORE_FORMATS
    PROPERTIES = (
        PropertyDescriptor("brightness", "float", 0.0, "Brightness adjustment",
                           -1.0, 1.0, controllable=True, traced=True),
        PropertyDescriptor("contrast", "float", 1.0, "Contrast adjustment",
                           0.0, 2.0, controllable=True, traced=True),
        PropertyDescriptor("saturation", "float", 1.0, "Saturation adjustment",
                           0.0, 2.0, controllable=True, traced=True),
        PropertyDescriptor("hue", "float", 0.0, "Hue rotation",
                           -1.0, 1.0, controllable=True, traced=True),
        PropertyDescriptor("gamma", "float", 1.0, "Gamma correction",
                           0.01, 10.0, controllable=True, traced=True),
        PropertyDescriptor("sharpness", "float", 0.0,
                           "Sharpness (<0 blur, >0 sharpen)",
                           -1.0, 1.0, controllable=True, traced=True),
        PropertyDescriptor("sepia", "float", 0.0, "Sepia tone amount",
                           0.0, 1.0, controllable=True, traced=True),
        PropertyDescriptor("invert", "bool", False, "Invert colors",
                           controllable=True, traced=True),
        PropertyDescriptor("noise", "float", 0.0, "Film grain amount",
                           0.0, 1.0, controllable=True, traced=True),
        PropertyDescriptor("vignette", "float", 0.0, "Vignette amount",
                           0.0, 1.0, controllable=True, traced=True),
        PropertyDescriptor("chroma-key-enabled", "bool", False,
                           "Enable chroma keying", traced=True),
        PropertyDescriptor("chroma-key-color", "color", 0xFF00FF00,
                           "Chroma key color (ARGB)", traced=True),
        PropertyDescriptor("chroma-key-tolerance", "float", 0.2,
                           "Chroma key tolerance", 0.0, 1.0, traced=True),
        PropertyDescriptor("chroma-key-smoothness", "float", 0.1,
                           "Chroma key edge smoothness", 0.0, 1.0, traced=True),
        PropertyDescriptor("lut-file", "string", None,
                           "Path to 3D LUT (.cube or .png)"),
    )

    # -- passthrough (m:114-138): every prop at default --------------------

    def is_passthrough(self, in_spec, out_spec):
        if in_spec.format != out_spec.format:
            return False
        return self.props.at_defaults()

    def static_config(self, in_spec, out_spec):
        g = self.props
        # static effect gates: a disabled effect is omitted (identical output)
        gates = (
            ("hue", abs(g.get("hue") * np.pi) > 0.001),
            ("gamma", g.get("gamma") != 1.0),
            ("sepia", g.get("sepia") > 0.001),
            ("invert", bool(g.get("invert"))),
            ("chroma_key", bool(g.get("chroma-key-enabled"))),
            ("vignette", g.get("vignette") > 0.001),
            ("noise", g.get("noise") > 0.001),
        )
        return (
            ("use_sharpness", abs(g.get("sharpness")) > 0.001),
            ("lut_file", g.get("lut-file")),
            ("gates", gates),
        )

    def traced_params(self, device=None):
        """tpuvf's traced scalars (same names, same float32 values) as 0-dim
        float32 tensors on `device`."""
        ck = self.props.get("chroma-key-color")
        values = {
            "brightness": self.props.get("brightness"),
            "contrast": self.props.get("contrast"),
            "saturation": self.props.get("saturation"),
            # hue [-1,1] -> radians [-pi,pi] (m:189)
            "hue": self.props.get("hue") * np.pi,
            "gamma": self.props.get("gamma"),
            "sharpness": self.props.get("sharpness"),
            "sepia": self.props.get("sepia"),
            "invert": 1.0 if self.props.get("invert") else 0.0,
            "noise": self.props.get("noise"),
            "vignette": self.props.get("vignette"),
            "chroma_key_enabled":
                1.0 if self.props.get("chroma-key-enabled") else 0.0,
            # ARGB -> RGB floats (m:199-201)
            "key_r": ((ck >> 16) & 0xFF) / 255.0,
            "key_g": ((ck >> 8) & 0xFF) / 255.0,
            "key_b": (ck & 0xFF) / 255.0,
            "key_tolerance": self.props.get("chroma-key-tolerance"),
            "key_smoothness": self.props.get("chroma-key-smoothness"),
        }
        return {k: torch.tensor(float(v), dtype=torch.float32, device=device)
                for k, v in values.items()}

    def init_state(self, in_spec, out_spec, device=None):
        # frame counter for grain animation; reset on stop (m:372-381)
        return {"frame_index": torch.zeros((), dtype=torch.int64,
                                           device=device)}

    def make_process(self, in_spec: FrameSpec, out_spec: FrameSpec, static,
                     device):
        cfg = dict(static)
        if cfg["lut_file"]:
            raise NotImplementedError(
                f"vfvideofilter lut-file is not ported yet {_NOT_PORTED}")
        if cfg["use_sharpness"]:
            raise NotImplementedError(
                f"vfvideofilter sharpness is not ported yet {_NOT_PORTED}")
        gates = dict(cfg["gates"])
        w, h = in_spec.width, in_spec.height
        sampler = convert.plan_rgba_sampler(
            in_spec, w, h, device, matrix_index=in_spec.matrix_index)
        coords = kfilter.plan_coords(w, h, device)
        matrix_out = out_spec.matrix_index

        def process(planes, state, params):
            frame_index = state["frame_index"]
            chans = kfilter.apply_color_adjustments_t(
                sampler(planes), params, frame_index, coords, gates=gates)
            out = convert.pack_rgba_t(chans, out_spec.format, matrix_out)
            # uint32 wrap, as tpuvf's uint32 counter
            return out, {"frame_index": (frame_index + 1) & 0xFFFFFFFF}

        return process
