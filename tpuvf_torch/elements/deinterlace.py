"""vfdeinterlace — bob / weave / linear / greedy-H deinterlacing (port of
``tpuvf.elements.deinterlace``, canonical full-frame path).

- formats BGRA, RGBA, NV12, I420
- props: method {bob=0, weave=1, linear=2, greedyh=3}, field-layout {auto,
  top-field-first, bottom-field-first}, motion-threshold [0,1]=0.1
  (gstvfmetaldeinterlace.m:73-112); the output is progressive
- field order: explicit, or with `auto` each buffer's TFF flag
  (m:169-185), which the runtime hands over as ``params["__meta__"]``;
  the stream's `FrameSpec.tff` when a buffer carries none
- one K5 launch a frame (``deinterlace.deinterlace_frame``) runs the whole
  body: the input's RGBA8 texture (nearest chroma upsample,
  metaldeinterlacerenderer.m:204-293: computed in registers for YUV inputs;
  the planes themselves for RGB inputs, exact as ``quant(dequant(v)) ==
  v``), the field logic and the output pack; the *input* texture becomes
  the previous frame (m:394-405), written out by the kernel for YUV inputs
- weave/greedy-H fall back to bob on the first frame (m:326-338);
  ``has_prev`` is a host bool, so the choice costs no device read
- no passthrough mode

State: ``{}`` for bob/linear, which never read the previous frame;
otherwise ``{"prev": (4, H, W) uint8 tensor, "has_prev": bool}``.  Under
sp row sharding a band runs K5 on its rows plus one even pair of halo rows
on each interior side (and the same rows of `prev`), and keeps its rows of
the output and of the texture.  tpuvf's split/quad link bodies are TPU
layouts and are not ported.
"""

from __future__ import annotations

import torch

from tpuvf_torch.core.element import Element
from tpuvf_torch.core.formats import CORE_FORMATS, RGB_FORMATS
from tpuvf_torch.core.properties import PropertyDescriptor
from tpuvf_torch.core.registry import register
from tpuvf_torch.core.spec import FrameSpec
from tpuvf_torch.kernels import convert
from tpuvf_torch.kernels.deinterlace import (
    METHOD_BOB,
    METHOD_LINEAR,
    deinterlace_frame,
)
from tpuvf_torch.kernels.sample import NEAREST

FIELD_AUTO, FIELD_TFF, FIELD_BFF = 0, 1, 2


@register
class Deinterlace(Element):
    ELEMENT_NAME = "vfdeinterlace"
    ALIASES = ("vfmetaldeinterlace", "deinterlace")
    KLASS = "Filter/Effect/Video/Deinterlace"
    DESCRIPTION = "Motion-adaptive GPU deinterlacing"
    IN_FORMATS = CORE_FORMATS
    OUT_FORMATS = CORE_FORMATS
    PROPERTIES = (
        PropertyDescriptor("method", "enum", 0, "Deinterlace method",
                           enum_values=(("bob", 0), ("weave", 1),
                                        ("linear", 2), ("greedyh", 3))),
        PropertyDescriptor("field-layout", "enum", 0, "Field order",
                           enum_values=(("auto", 0), ("top-field-first", 1),
                                        ("bottom-field-first", 2))),
        PropertyDescriptor("motion-threshold", "float", 0.1,
                           "Motion threshold for greedyh", 0.0, 1.0,
                           controllable=True, traced=True),
    )

    def transform_spec(self, in_spec, out_filter=None):
        # deinterlaced output is progressive
        return super().transform_spec(in_spec, out_filter).with_(
            interlaced=False)

    def _stateless(self) -> bool:
        return self.props.get("method") in (METHOD_BOB, METHOD_LINEAR)

    def init_state(self, in_spec, out_spec, device=None):
        if self._stateless():
            # bob/linear never read the previous frame (tpuvf carries no
            # state for them either)
            return {}
        return {"prev": torch.zeros((4, in_spec.height, in_spec.width),
                                    dtype=torch.uint8, device=device),
                "has_prev": False}

    # -- dp/sp sharding (tpuvf/elements/deinterlace.py:117-138) -----------

    def dp_shard_safe(self, in_spec, out_spec):
        """bob and linear ignore the previous frame; weave and greedy-H
        read it, so a stream split across dp shards would give each shard
        its own history."""
        return self._stateless()

    def sp_row_shardable(self, in_spec, out_spec):
        """RGB, or 4:2:0 of even width and height (tpuvf's canonical
        rule): every method is a +-1-row stencil over the kept field,
        whose parity is the frame's because a band starts on an even row;
        `prev` is banded with the planes."""
        return (in_spec.format in RGB_FORMATS
                or convert.phase_capable(in_spec, out_spec))

    def band_reach(self, in_spec, out_spec):
        """The field stencil's row above and below, rounded to 2 (the
        NEAREST chroma of a 4:2:0 texture needs no halo)."""
        return 2

    def make_process(self, in_spec: FrameSpec, out_spec: FrameSpec, static,
                     device, band=None):
        cfg = dict(static)
        method, layout = cfg["method"], cfg["field-layout"]
        stateless = method in (METHOD_BOB, METHOD_LINEAR)
        static_tff = (bool(in_spec.tff) if layout == FIELD_AUTO
                      else layout == FIELD_TFF)
        window = None if band is None else (band.in_lo, band.in_hi)
        taps = (None if in_spec.format in RGB_FORMATS
                else convert.plan_chroma_taps(in_spec, device, NEAREST,
                                              rows=window))
        trim = (lambda planes: planes) if band is None else band.trim
        matrix_in, matrix_out = in_spec.matrix_index, out_spec.matrix_index

        def resolve_tff(params) -> bool:
            if layout != FIELD_AUTO:
                return static_tff
            flag = (params.get("__meta__") or {}).get("tff")
            return static_tff if flag is None else flag != 0

        def process(planes, state, params):
            if stateless:
                prev, has_prev = None, False
            else:
                prev, has_prev = state["prev"], state["has_prev"]
            out, tex = deinterlace_frame(
                planes, prev, method, resolve_tff(params), has_prev,
                params["motion-threshold"], taps, matrix_in, out_spec.format,
                matrix_out)
            out = trim(out)
            if stateless:
                return out, state
            # blit input -> prevFrame (m:394-405)
            return out, {"prev": trim({"prev": tex})["prev"],
                         "has_prev": True}

        return process
