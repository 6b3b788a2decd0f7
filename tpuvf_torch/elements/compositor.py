"""vfcompositor — N-input mixed-format alpha/z-order compositor (port of
``tpuvf.elements.compositor``).

- request pads ``sink_%u`` with props xpos/ypos (int, full range),
  width/height (-1 = input size; 0 unscaled too when zero-size-is-unscaled),
  alpha [0,1]=1, operator {source, over, add}=over, sizing-policy {none,
  keep-aspect-ratio}, zorder (pads composited in zorder order)
- element props background {checker, black, white, transparent},
  zero-size-is-unscaled, ignore-inactive-pads
- geometry: pad_get_output_size (gstvfmetalcompositor.m:202-325) — DAR
  correction per sizing-policy, keep-aspect-ratio centering offsets
- caps: output = bounding box of (pad rect + max(pos,0)) over pads, max
  input fps (default 25/1), PAR 1/1, BGRA preferred (update_caps
  m:394-458, fixate m:460-540)
- per-pad skip rules: alpha==0, zero clamped rect, obscured by a
  higher-zorder opaque pad (compositorpad.m:179-246); fully obscured
  background becomes transparent (m:360-385)
- blending (metalcomprenderer.m): fragments multiply uniform alpha then
  premultiply rgb; SOURCE=(one,zero), OVER=(one,one-minus-src-alpha),
  ADD=(one,one); checker background is 8x8-px 0.75/0.5 gray

Per frame the pipeline runs the reference's CPU prepare pass on the host
in Python scalars (`make_aggregate`'s ``process.draw_table``: the pad
geometry, alpha and operator arrive from `traced_values` as host numbers,
so no frame waits for the device) and stages its result, the draw table of
K4 (``kernels/composite.py`` `pack_table`: each draw's position, clamped
rect, operator, alpha and drawn flag, and whether the background is
drawn), on the device with one pinned non-blocking copy, under
``params[DRAW_TABLE]``.  The process samples every pad that can draw at
its pad size (RGB pads through the K1/K1b sampler, uint8 at identity; YUV
pads through K1/K1b and the emit K2 to float32), whether or not the table
draws it this frame, folds every draw over the background in one launch of
K4, which reads the table on the card, and packs the RGBA8 canvas to the
output format.  So the launches and their arguments do not depend on where
the pads are: a moving or fading pad replays one captured CUDA graph
(`runtime/compiled.py`), as tpuvf's traced geometry recompiles nothing.

Folded overlays (``fold_overlays``, planned by the pipeline for an RGB
output, tpuvf's ``make_aggregate(..., fold_overlays=)``): each downstream
vfoverlay's rect blend is a final mix draw of the same K4 launch, its
float32 rect planes resampled at build time and its alpha read each frame
from this element's params as ``fold.<name>.alpha``; the overlay's own
stage is a passthrough.

Pad properties take schedules as ``control("sink_N::prop", ...)`` (the
``_ctl_*`` hooks); `navigation_event` hit-tests the pads for the
pipeline's navigation routing.  Under sp row sharding each band renders its
canvas rows from the whole pads (`make_aggregate`'s `band`) and the
frame's draw table, the pads' branches running replicated.  Not ported
(ROADMAP): tpuvf's split/cells/masked render bodies and
``aggregate_split_ok`` (TPU layouts).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from tpuvf_torch.core.element import Element
from tpuvf_torch.core.formats import CORE_FORMATS, RGB_FORMATS, VideoFormat
from tpuvf_torch.core.properties import PropertyBag, PropertyDescriptor
from tpuvf_torch.core.registry import register
from tpuvf_torch.core.spec import CapsFilter, Fraction, FrameSpec
from tpuvf_torch.kernels import convert
from tpuvf_torch.kernels.composite import (
    OP_ADD,
    OP_OVER,
    OP_SOURCE,
    Background,
    Source,
    background_colors,
    composite_fold,
    pack_table,
    table_size,
)
from tpuvf_torch.kernels.emit import emit
from tpuvf_torch.kernels.sample import LINEAR

BG_CHECKER, BG_BLACK, BG_WHITE, BG_TRANSPARENT = 0, 1, 2, 3
DRAW_TABLE = "__draw_table__"  # the params key of the staged draw table
SIZING_NONE, SIZING_KEEP_ASPECT = 0, 1

# (r, g, b, a) of checker cells 0 and 1, by background mode
_BACKGROUNDS = {
    BG_CHECKER: ((0.5, 0.5, 0.5, 1.0), (0.75, 0.75, 0.75, 1.0)),
    BG_BLACK: ((0.0, 0.0, 0.0, 1.0),) * 2,
    BG_WHITE: ((1.0, 1.0, 1.0, 1.0),) * 2,
    BG_TRANSPARENT: ((0.0, 0.0, 0.0, 0.0),) * 2,
}

PAD_PROPERTIES = (
    PropertyDescriptor("xpos", "int", 0, "X position",
                       -(2**31), 2**31 - 1, controllable=True),
    PropertyDescriptor("ypos", "int", 0, "Y position",
                       -(2**31), 2**31 - 1, controllable=True),
    PropertyDescriptor("width", "int", -1, "Width (-1 = input width)",
                       -1, 2**31 - 1, controllable=True),
    PropertyDescriptor("height", "int", -1, "Height (-1 = input height)",
                       -1, 2**31 - 1, controllable=True),
    PropertyDescriptor("alpha", "float", 1.0, "Alpha", 0.0, 1.0,
                       controllable=True),
    PropertyDescriptor("operator", "enum", OP_OVER, "Blending operator",
                       enum_values=(("source", OP_SOURCE), ("over", OP_OVER),
                                    ("add", OP_ADD)),
                       controllable=True),
    PropertyDescriptor("sizing-policy", "enum", SIZING_NONE, "Sizing policy",
                       enum_values=(("none", 0), ("keep-aspect-ratio", 1))),
    PropertyDescriptor("zorder", "uint", 0, "Z order", 0, 2**32 - 1,
                       controllable=True),
)


def _center_rect(src_w, src_h, dst_w, dst_h):
    """gst_video_center_rect with scaling=TRUE: aspect-fit src into dst,
    centered; returns (x, y, w, h)."""
    src_ratio = src_w / src_h
    dst_ratio = dst_w / dst_h
    if src_ratio > dst_ratio:
        w = dst_w
        h = int(round(dst_w / src_ratio))
    elif src_ratio < dst_ratio:
        h = dst_h
        w = int(round(dst_h * src_ratio))
    else:
        w, h = dst_w, dst_h
    return (dst_w - w) // 2, (dst_h - h) // 2, w, h


class CompositorPadConfig:
    """Resolved geometry of one pad for a given output spec."""

    def __init__(self, name, spec, bag):
        self.name = name
        self.spec = spec
        self.bag = bag

    def output_size(self, comp, out_par: Fraction):
        """pad_get_output_size (m:202-325): (width, height, x_off, y_off)."""
        bag, spec = self.bag, self.spec
        zero_unscaled = comp.props.get("zero-size-is-unscaled")
        pw, ph = bag.get("width"), bag.get("height")
        if zero_unscaled:
            pad_w = spec.width if pw <= 0 else pw
            pad_h = spec.height if ph <= 0 else ph
        else:
            pad_w = spec.width if pw < 0 else pw
            pad_h = spec.height if ph < 0 else ph
        if pad_w == 0 or pad_h == 0:
            return 0, 0, 0, 0
        # display ratio: dar = (w * par_in) / (h * par_out)
        dar = Fraction(pad_w, pad_h) * spec.par / out_par
        x_off = y_off = 0
        if bag.get("sizing-policy") == SIZING_NONE:
            if pad_h % dar.num == 0:
                pad_w = pad_h * dar.num // dar.den
            elif pad_w % dar.den == 0:
                pad_h = pad_w * dar.den // dar.num
            else:
                pad_w = pad_h * dar.num // dar.den
        else:  # keep-aspect-ratio
            from_dar = Fraction(spec.width, spec.height) * spec.par
            to_dar = Fraction(pad_w, pad_h) * out_par
            if from_dar != to_dar:
                num_den = from_dar / out_par  # from_dar * par_d/par_n
                src_h = pad_w * num_den.den // num_den.num
                if src_h == 0:
                    return 0, 0, 0, 0
                x_off, y_off, pad_w, pad_h = _center_rect(
                    pad_w, src_h, pad_w, pad_h
                )
        return pad_w, pad_h, x_off, y_off


class _PadPlan(NamedTuple):
    """One pad that can draw: its rect size, centering offsets and sampler
    (pad planes -> (4, h, w) uint8 or float32 RGBA at pad size)."""

    name: str
    width: int
    height: int
    x_off: int
    y_off: int
    sample: object
    opaque: bool  # no alpha channel: may obscure (pad_obscures_rectangle)


def _plan_sampler(spec: FrameSpec, w: int, h: int, device):
    if spec.format in RGB_FORMATS:
        run = convert.plan_plane_sampler(spec.width, spec.height, w, h,
                                         LINEAR, 1.0, 1.0, device)
        return lambda planes: run(planes["rgba"])
    run = convert.plan_rgba_sampler(spec, w, h, device)
    matrix = spec.matrix_index
    return lambda planes: emit(run(planes), matrix, out_float=True)


@register
class Compositor(Element):
    ELEMENT_NAME = "vfcompositor"
    ALIASES = ("vfmetalcompositor", "compositor", "comp")
    KLASS = "Filter/Editor/Video/Compositor"
    DESCRIPTION = "Composites multiple video streams with a CUDA blend fold"
    IN_FORMATS = CORE_FORMATS
    OUT_FORMATS = CORE_FORMATS
    PROPERTIES = (
        PropertyDescriptor("background", "enum", BG_CHECKER, "Background type",
                           enum_values=(("checker", 0), ("black", 1),
                                        ("white", 2), ("transparent", 3))),
        PropertyDescriptor("zero-size-is-unscaled", "bool", True,
                           "0 pad width/height means unscaled"),
        PropertyDescriptor("ignore-inactive-pads", "bool", False,
                           "Ignore pads without buffers"),
    )

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.pads: Dict[str, PropertyBag] = {}
        self._pad_insert_order: Dict[str, int] = {}
        self._fold_elems = []  # the overlays the last make_aggregate folded
        self._last_pad_specs: Dict[str, FrameSpec] = {}  # navigation_event

    # -- GstChildProxy analog: request pads ------------------------------

    def get_pad(self, name: str) -> PropertyBag:
        if name not in self.pads:
            self.pads[name] = PropertyBag(PAD_PROPERTIES)
            self._pad_insert_order[name] = len(self._pad_insert_order)
        return self.pads[name]

    def _sorted_pads(self, pad_specs):
        """Pads in composite order: zorder, then pad index (the element keeps
        sinkpads zorder-sorted, m:850-879; sink_%u index breaks ties)."""

        def pad_index(name):
            digits = "".join(ch for ch in name if ch.isdigit())
            return int(digits) if digits else self._pad_insert_order.get(name, 0)

        items = []
        for name, spec in pad_specs.items():
            bag = self.get_pad(name)
            items.append((bag.get("zorder"), pad_index(name), name, spec, bag))
        items.sort(key=lambda t: (t[0], t[1]))
        return [CompositorPadConfig(n, s, b) for _, _, n, s, b in items]

    # -- negotiation (update_caps m:394-458 + fixate m:460-540) ----------

    def aggregate_spec(
        self, pad_specs: Dict[str, FrameSpec], out_filter: Optional[CapsFilter]
    ) -> FrameSpec:
        if not pad_specs:
            raise ValueError("compositor has no sink pads")
        for spec in pad_specs.values():
            if spec.format not in self.IN_FORMATS:
                raise ValueError(f"unsupported input format {spec.format}")
        out_par = ((out_filter.fixate("par", Fraction(1, 1)) if out_filter
                    else None) or Fraction(1, 1))
        best_w = best_h = -1
        best_fps = None
        for pad in self._sorted_pads(pad_specs):
            w, h, x_off, y_off = pad.output_size(self, out_par)
            if w == 0 or h == 0:
                continue
            this_w = w + max(pad.bag.get("xpos") + 2 * x_off, 0)
            this_h = h + max(pad.bag.get("ypos") + 2 * y_off, 0)
            best_w = max(best_w, this_w)
            best_h = max(best_h, this_h)
            fps = pad.spec.fps
            if best_fps is None or float(fps) > float(best_fps):
                best_fps = fps
        if best_w <= 0 or best_h <= 0:
            raise ValueError("compositor could not determine output size")
        if best_fps is None or float(best_fps) == 0.0:
            best_fps = Fraction(25, 1)
        # fixate against the offered constraints: format prefers BGRA
        # (m:533), dims/fps prefer the bounding-box/max-fps picks
        filt = out_filter or CapsFilter()
        fmt = filt.fixate("format", VideoFormat.BGRA) or VideoFormat.BGRA
        w = filt.fixate("width", best_w) or best_w
        h = filt.fixate("height", best_h) or best_h
        fps = filt.fixate("fps", best_fps) or best_fps
        return FrameSpec(format=fmt, width=w, height=h, fps=fps, par=out_par)

    # -- static config covers the STRUCTURAL pad props only ---------------
    # xpos/ypos/alpha/operator are GST_PARAM_CONTROLLABLE in the reference
    # (gstvfmetalcompositorpad.m:282-315): they reach each frame as params,
    # so moving a pad rebuilds nothing.  width/height/sizing-policy change
    # the sampled sizes and zorder the draw order: those rebuild.

    _TRACED_PAD_PROPS = ("xpos", "ypos", "alpha", "operator")

    def static_config(self, in_spec, out_spec):
        base = super().static_config(in_spec, out_spec)
        pads = tuple(
            (name, tuple(sorted(
                (k, v) for k, v in bag.snapshot().items()
                if k not in self._TRACED_PAD_PROPS
            )))
            for name, bag in sorted(self.pads.items())
        )
        return base + (("pads", pads),)

    # -- pad property schedules ("sink_0::xpos", tpuvf/elements/compositor.py:
    # 244-261): Element.control and sync_frame reach a pad's bag through
    # these hooks, so a pad ramp rides the same per-frame machinery

    def _ctl_has(self, name):
        if "::" in name:
            pad, prop = name.split("::", 1)
            return self.get_pad(pad).has(prop)
        return super()._ctl_has(name)

    def _ctl_get(self, name):
        if "::" in name:
            pad, prop = name.split("::", 1)
            return self.get_pad(pad).get(prop)
        return super()._ctl_get(name)

    def _ctl_set(self, name, value):
        if "::" in name:
            pad, prop = name.split("::", 1)
            self.get_pad(pad).set(prop, value)
            return
        super()._ctl_set(name, value)

    def traced_values(self, device=None):
        """tpuvf's per-pad params (same keys) as host numbers, handed over
        as they are: xpos, ypos and operator Python ints, alpha a Python
        float holding its float32 value.  Nothing is staged on `device`:
        the prepare pass (``process.draw_table``) reads them on the host,
        and only its table reaches the device."""
        scalars, out = super().traced_values(device)
        for name, bag in self.pads.items():
            out[f"pad.{name}.xpos"] = int(bag.get("xpos"))
            out[f"pad.{name}.ypos"] = int(bag.get("ypos"))
            out[f"pad.{name}.alpha"] = float(np.float32(bag.get("alpha")))
            out[f"pad.{name}.operator"] = int(bag.get("operator"))
        # folded overlays' controllable alpha rides this element's params
        for ov in self._fold_elems:
            out[f"fold.{ov.name}.alpha"] = float(np.float32(
                ov.props.get("alpha")))
        return scalars, out

    # -- navigation (src-pad events hit-tested per pad, m:705-787) ---------

    def navigation_event(self, x: float, y: float, pad_specs=None,
                         out_par: Fraction = Fraction(1, 1)):
        """Map an output-space pointer position to (pad_name, pad_x, pad_y)
        for the topmost pad whose rect contains it, rescaled into that
        pad's input coordinates; None when no pad is hit (tpuvf's
        ``navigation_event``, ``tpuvf/elements/compositor.py:280-298``)."""
        pad_specs = pad_specs or self._last_pad_specs
        if not pad_specs:
            return None
        for pad in reversed(self._sorted_pads(pad_specs)):  # top-down
            w, h, x_off, y_off = pad.output_size(self, out_par)
            if w == 0 or h == 0:
                continue
            px = pad.bag.get("xpos") + x_off
            py = pad.bag.get("ypos") + y_off
            if px <= x < px + w and py <= y < py + h:
                ix = (x - px) * pad.spec.width / w
                iy = (y - py) * pad.spec.height / h
                return pad.name, ix, iy
        return None

    # -- planning ----------------------------------------------------------

    def sp_row_shardable(self, in_spec, out_spec):
        """Any geometry (tpuvf: the canvas is banded; the pads enter
        replicated, full rows on every band, per the pipeline's sp plan)."""
        return True

    def make_aggregate(self, pad_specs: Dict[str, FrameSpec],
                       out_spec: FrameSpec, device, fold_overlays=(),
                       band=None):
        """Plan the aggregate on `device` -> process(pad_inputs, state,
        params) -> (output planes, state), with ``process.draw_table(params,
        pad_meta)``, the host prepare pass -> the frame's int32 draw table
        (`composite.pack_table`, `process.table_size` entries), which the
        caller stages on the device as ``params[DRAW_TABLE]``.  With `band`
        (a ``parallel.bands.Band`` of the canvas) the process renders the
        canvas rows [band.lo, band.hi) from the whole pads and the frame's
        table: K4 clips each draw to the band, the checker on the frame's
        rows.

        `pad_inputs` maps each pad name to its canonical device planes;
        `params` holds this element's `traced_params` and the table (where
        it holds none, the process computes it from them and
        ``params["__pad_meta__"]`` and copies it to `device` itself);
        `pad_meta` maps each pad to its buffer's flags from the runtime
        clock: 'active' (the stream has started) and 'eos' (past its last
        buffer: the frozen last frame keeps drawing unless
        ignore-inactive-pads).  `fold_overlays`: vfoverlay elements
        blended as final mix draws (module doc); the caller has checked
        that they can fold."""
        self._last_pad_specs = dict(pad_specs)
        out_w, out_h = out_spec.width, out_spec.height
        ignore_inactive = bool(self.props.get("ignore-inactive-pads"))
        colors = background_colors(_BACKGROUNDS[self.props.get("background")])
        plans = []
        for pad in self._sorted_pads(pad_specs):
            w, h, x_off, y_off = pad.output_size(self, out_spec.par)
            if w == 0 or h == 0:
                continue  # zero-size rect: never drawn
            plans.append(_PadPlan(pad.name, w, h, x_off, y_off,
                                  _plan_sampler(pad.spec, w, h, device),
                                  pad.spec.format not in RGB_FORMATS))
        out_format, matrix_out = out_spec.format, out_spec.matrix_index
        background = Background(colors, 0 if band is None else band.lo)
        rows = out_h if band is None else band.rows
        mixes = []  # (overlay name, (4, h, w) float32 rect planes, rect)
        for ov in fold_overlays:
            (x0, x1, y0, y1), planes = ov.fold_rect(out_spec)
            if x1 > x0 and y1 > y0:
                mixes.append((ov.name, torch.from_numpy(planes).to(device),
                              (x0, y0, x1, y1)))
        self._fold_elems = list(fold_overlays)

        def has_buffer(meta) -> bool:
            meta = meta or {}
            started = meta.get("active")
            started = 1.0 if started is None else float(started)
            eos = meta.get("eos")
            eos = 0.0 if eos is None else float(eos)
            return (started * (1.0 - eos) if ignore_inactive else started) > 0

        def draw_table(params, pad_meta, out=None):
            """The prepare pass (prepare_frame_start m:159-246), on the
            host -> the frame's draw table."""
            pad_meta = pad_meta or {}
            prep = []
            for d in plans:
                x = int(params[f"pad.{d.name}.xpos"]) + d.x_off
                y = int(params[f"pad.{d.name}.ypos"]) + d.y_off
                alpha = float(params[f"pad.{d.name}.alpha"])
                buffered = has_buffer(pad_meta.get(d.name))
                rect = (min(max(x, 0), out_w), min(max(y, 0), out_h),
                        min(max(x + d.width, 0), out_w),
                        min(max(y + d.height, 0), out_h))
                nonempty = rect[2] > rect[0] and rect[3] > rect[1]
                prep.append(dict(
                    d=d, x=x, y=y, alpha=alpha, rect=rect,
                    visible=buffered and alpha > 0 and nonempty,
                    # an opaque format with alpha 1 and a buffer obscures
                    # what its UNCLAMPED rect contains (m:328-358)
                    obscuring=d.opaque and buffered and alpha >= 1.0))

            def contains(q, x0, y0, x1, y1):
                return (q["x"] <= x0 and q["y"] <= y0
                        and q["x"] + q["d"].width >= x1
                        and q["y"] + q["d"].height >= y1)

            # background: transparent when an obscuring pad covers the whole
            # canvas (_should_draw_background m:360-385)
            bg_drawn = not any(p["obscuring"] and p["visible"]
                               and contains(p, 0, 0, out_w, out_h)
                               for p in prep)
            draws = []
            for i, p in enumerate(prep):
                # drawn: visible and not obscured by a LATER (higher-zorder)
                # obscuring pad containing its clamped rect (m:219-246)
                drawn = p["visible"] and not any(
                    q["obscuring"] and contains(q, *p["rect"])
                    for q in prep[i + 1:])
                draws.append((p["x"], p["y"], p["rect"],
                              int(params[f"pad.{p['d'].name}.operator"]),
                              p["alpha"], drawn))
            # folded overlays: rgb = rgb * (1 - a) + ov * a, alpha kept
            for name, _, rect in mixes:
                draws.append((rect[0], rect[1], rect, OP_OVER,
                              float(params[f"fold.{name}.alpha"]), True))
            return pack_table(bg_drawn, draws, out)

        def process(pad_inputs, state, params):
            table = params.get(DRAW_TABLE)
            if table is None:  # a caller that staged none: one copy here
                table = torch.from_numpy(draw_table(
                    params, params.get("__pad_meta__"))).to(device)
            sources = [Source(d.sample(pad_inputs[d.name])) for d in plans]
            sources += [Source(planes, True) for _, planes, _ in mixes]
            canvas = composite_fold(rows, out_w, background, sources, table,
                                    device)
            return convert.pack_rgba(canvas, out_format, matrix_out), state

        process.draw_table = draw_table
        process.table_size = table_size(len(plans) + len(mixes))
        return process
