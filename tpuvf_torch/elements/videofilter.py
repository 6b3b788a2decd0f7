"""vfvideofilter — the color-adjustment effect chain (port of
``tpuvf.elements.videofilter``, canonical path).

- formats BGRA, RGBA, NV12, I420 (gstvfmetalvideofilter.m:53)
- 15 properties with the reference ranges/defaults (m:67-101, 435-533); the
  controllable color/effect props are traced scalars (0-dim float32 tensors)
- passthrough iff every property is at its default, FLOAT_EQ eps 1e-6
  (m:114-138)
- a per-frame monotonically increasing frameIndex drives the grain hash
  (m:183-205); carried as explicit state with uint32 wrap
- `lut-file` loads a .cube or PNG LUT on the property write; a load that
  fails logs a warning and leaves no LUT, as in tpuvf (m:281-294).  The
  corner-packed table is float32 always (the reference's RGBA32Float
  storage) and is uploaded once per load and device
- the phases of the reference renderer (metalvideofilterrenderer.m:523-695)
  with their RGBA8 quantization boundaries: sampler -> adjustments (K2) ->
  3D LUT (K3, quantizing) -> when |sharpness| > 0.001 the separable blur and
  unsharp mask (plain torch) -> output pack
- under sp row sharding a band runs the chain on its rows plus the halo of
  the chroma row upsample and the blur, with the vignette and grain rows of
  the frame, and keeps its rows
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from tpuvf_torch.core.element import Element
from tpuvf_torch.core.formats import (CORE_FORMATS, PLANAR_YUV_FORMATS,
                                      RGB_FORMATS)
from tpuvf_torch.core.properties import PropertyDescriptor
from tpuvf_torch.core.registry import register
from tpuvf_torch.core.spec import FrameSpec
from tpuvf_torch.io import lut as lutio
from tpuvf_torch.kernels import convert, filter as kfilter
from tpuvf_torch.kernels.color import dequant, quant
from tpuvf_torch.kernels.emit import Adjust, emit
from tpuvf_torch.kernels.lut import lut3d
from tpuvf_torch.parallel import bands

_log = logging.getLogger("tpuvf_torch.videofilter")


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

    def __init__(self, *a, **k):
        self._lut = None  # corner-packed float32 (S^3, 24) numpy table
        self._lut_size = 0
        self._lut_path_loaded = None
        self._lut_on = {}  # torch.device -> the table uploaded there
        super().__init__(*a, **k)

    # -- LUT lifecycle (load on property write, soft-fail keeps no LUT,
    #    gstvfmetalvideofilter.m:281-294) --------------------------------

    def set_property(self, name, value):
        super().set_property(name, value)
        if name == "lut-file":
            self._reload_lut()

    def _reload_lut(self):
        path = self.props.get("lut-file")
        self._lut, self._lut_size, self._lut_path_loaded = None, 0, None
        self._lut_on = {}
        if not path:
            return
        try:
            table = lutio.load(path)
        except Exception as exc:  # noqa: BLE001 - any unreadable file soft-fails
            _log.warning("failed to load LUT %s: %s", path, exc)
            return
        self._lut = kfilter.pack_lut_corners(table)
        self._lut_size = table.shape[0]
        self._lut_path_loaded = path

    def _sync_lut(self):
        if self.props.get("lut-file") != self._lut_path_loaded:
            self._reload_lut()

    # -- passthrough (m:114-138): every prop at default AND no LUT loaded --

    def is_passthrough(self, in_spec, out_spec):
        self._sync_lut()
        if in_spec.format != out_spec.format:
            return False
        return self.props.at_defaults() and self._lut is None

    def static_config(self, in_spec, out_spec):
        self._sync_lut()
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
            ("lut_size", self._lut_size),
            ("gates", gates),
        )

    def traced_values(self, device=None):
        """tpuvf's traced scalars (same names; the step reads them as
        float32), and the LUT table on `device` under "lut" when one is
        loaded."""
        self._sync_lut()
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
        other = {}
        if self._lut is not None:
            dev = torch.device("cpu" if device is None else device)
            if dev not in self._lut_on:
                self._lut_on[dev] = torch.from_numpy(self._lut).to(dev)
            other["lut"] = self._lut_on[dev]
        return {k: float(v) for k, v in values.items()}, other

    def init_state(self, in_spec, out_spec, device=None):
        # frame counter for grain animation; reset on stop (m:372-381)
        return {"frame_index": torch.zeros((), dtype=torch.int64,
                                           device=device)}

    # -- dp/sp sharding (tpuvf/elements/videofilter.py:218-239) -----------

    def dp_shard_safe(self, in_spec, out_spec):
        """The frame counter feeds only the grain hash: with noise off a
        stream may batch-split across dp shards."""
        return self.props.get("noise") <= 0.001

    def sp_row_shardable(self, in_spec, out_spec):
        """RGB, or 4:2:0 of even width and height (tpuvf's canonical rule,
        ``convert.phase_capable``)."""
        return (in_spec.format in RGB_FORMATS
                or convert.phase_capable(in_spec, out_spec))

    def band_reach(self, in_spec, out_spec):
        """The 4:2:0 chroma row upsample (2 rows), then the 9-tap vertical
        blur (4 rows) when sharpness is on; the adjust chain and the LUT
        are per pixel, their coordinate fields the frame's rows."""
        reach = 2 if in_spec.format in PLANAR_YUV_FORMATS else 0
        if dict(self.static_config(in_spec, out_spec))["use_sharpness"]:
            reach += 4
        return reach

    def make_process(self, in_spec: FrameSpec, out_spec: FrameSpec, static,
                     device, band=None):
        cfg = dict(static)
        use_sharpness = cfg["use_sharpness"]
        lut_size = cfg["lut_size"]
        gates = dict(cfg["gates"])
        w, h = in_spec.width, in_spec.height
        rows = y = None
        if band is not None:
            # the blur reads its halo rows, which the band then drops;
            # without it the band's own rows are all the chain computes
            y = bands.global_rows(band, window=use_sharpness)
            rows = (int(y[0]), int(y[-1]) + 1, band.in_lo, band.in_hi)
        coords = kfilter.plan_coords(w, h, device, rows=y)
        sampler = convert.plan_rgba_sampler(in_spec, w, h, device, rows=rows)
        trim = band.trim if band is not None and use_sharpness else None
        matrix_in, matrix_out = in_spec.matrix_index, out_spec.matrix_index

        def process(planes, state, params):
            frame_index = state["frame_index"]
            adjust = Adjust(params, frame_index, coords, gates)
            if lut_size:
                chans = emit(sampler(planes), matrix_in, adjust=adjust,
                             out_float=True)
                rgba_q = lut3d(chans, params["lut"], lut_size, quantize=True)
            else:
                rgba_q = emit(sampler(planes), matrix_in, adjust=adjust)
            if use_sharpness:
                # RGBA8 boundaries between the blur passes (the reference
                # renders each pass to an RGBA8 texture)
                bh = quant(kfilter.blur9(dequant(rgba_q), axis=-1))
                bv = quant(kfilter.blur9(dequant(bh), axis=-2))
                rgba_q = quant(kfilter.unsharp_mask(
                    dequant(rgba_q), dequant(bv), params["sharpness"]))
                if trim is not None:
                    rgba_q = trim({"rgba": rgba_q})["rgba"]
            out = convert.pack_rgba(rgba_q, out_spec.format, matrix_out)
            # uint32 wrap, as tpuvf's uint32 counter
            return out, {"frame_index": (frame_index + 1) & 0xFFFFFFFF}

        return process
