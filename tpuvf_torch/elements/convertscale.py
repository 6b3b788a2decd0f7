"""vfconvertscale — format conversion + scaling (port of
``tpuvf.elements.convertscale``, canonical path).

- formats BGRA, RGBA, NV12, I420, UYVY, YUY2 (gstvfmetalconvertscale.m:48);
  packed 4:2:2 frames cannot enter or leave a pipeline yet (core.frame)
- props: method {bilinear=0, nearest=1}, add-borders (letterbox, default
  FALSE), border-color ARGB default 0xFF000000 (m:70-72)
- fixate: preserve input format; fix output dims preserving display aspect
  ratio given the output PAR (m:160-248)
- passthrough iff same format and dims (m:272-280)

Per frame: sample the input planes at the output grid through the 2-tap
resample kernels K1/K1b (letterbox folded into the taps) -> the fused emit
K2 (RGBA conversion, the letterbox border, quantization to the RGBA8
intermediate) -> pack to the output format.  Under sp row sharding a band
computes its output rows: at identity rows from its rows and a 4:2:0
input's chroma halo, else from every input row through the tap table's
band rows (``resample.band_taps``).  tpuvf's split/quad/grid link layouts
only move bytes between elements and are not ported.
"""

from __future__ import annotations

from tpuvf_torch.core.element import Element
from tpuvf_torch.core.formats import ALL_FORMATS, PLANAR_YUV_FORMATS
from tpuvf_torch.core.properties import PropertyDescriptor, argb_to_rgba_floats
from tpuvf_torch.core.registry import register
from tpuvf_torch.core.spec import CapsFilter, Fraction, FrameSpec
from tpuvf_torch.kernels import convert
from tpuvf_torch.kernels.emit import emit
from tpuvf_torch.kernels.sample import LINEAR, NEAREST, letterbox_scales
from tpuvf_torch.parallel import bands

METHOD_BILINEAR = 0
METHOD_NEAREST = 1


@register
class ConvertScale(Element):
    ELEMENT_NAME = "vfconvertscale"
    ALIASES = ("vfmetalconvertscale", "convertscale",
               "videoconvert", "videoscale")
    KLASS = "Filter/Converter/Video/Scaler"
    DESCRIPTION = "Converts video format and scales with 2-tap CUDA kernels"
    IN_FORMATS = ALL_FORMATS
    OUT_FORMATS = ALL_FORMATS
    PROPERTIES = (
        PropertyDescriptor(
            "method", "enum", METHOD_BILINEAR,
            "Scaling interpolation method",
            enum_values=(("bilinear", 0), ("nearest", 1)),
        ),
        PropertyDescriptor(
            "add-borders", "bool", False,
            "Add letterbox/pillarbox borders to preserve aspect ratio",
        ),
        PropertyDescriptor(
            "border-color", "color", 0xFF000000,
            "Border color in ARGB format",
        ),
    )

    def transform_spec(self, in_spec: FrameSpec, out_filter=None) -> FrameSpec:
        """transform_caps offers any format/size (m:105-158); fixate preserves
        input format and fixes output dims preserving display aspect ratio
        given the output PAR, nearest against offered ranges/lists
        (m:160-248)."""
        if not self.accepts_format(in_spec.format):
            raise ValueError(f"unsupported input format {in_spec.format}")
        filt = out_filter or CapsFilter()
        fmt = filt.fixate("format", in_spec.format) or in_spec.format
        par = filt.fixate("par", Fraction(1, 1)) or Fraction(1, 1)
        # input DAR = from_w*par_n / from_h*par_d
        dar = Fraction(in_spec.width, in_spec.height) * in_spec.par

        def dar_h(w):
            return max(1, (w * dar.den * par.num) // (dar.num * par.den))

        def dar_w(h):
            return max(1, (h * dar.num * par.den) // (dar.den * par.num))

        w_fixed, h_fixed = filt.is_fixed("width"), filt.is_fixed("height")
        if w_fixed and h_fixed:
            w, h = filt.width, filt.height
        elif w_fixed:
            w = filt.width
            h = filt.fixate("height", dar_h(w)) or dar_h(w)
        elif h_fixed:
            h = filt.height
            w = filt.fixate("width", dar_w(h)) or dar_w(h)
        else:
            # neither fixed: keep input width (nearest in the offered
            # range), DAR-derive the height
            w = filt.fixate("width", in_spec.width) or in_spec.width
            h = filt.fixate("height", dar_h(w)) or dar_h(w)
        fps = filt.fixate("fps", in_spec.fps) or in_spec.fps
        return FrameSpec(
            format=fmt, width=w, height=h,
            fps=fps, par=par,
            matrix=in_spec.matrix,
            interlaced=in_spec.interlaced, tff=in_spec.tff,
        )

    def is_passthrough(self, in_spec, out_spec):
        # m:272-280 — same format and dimensions => passthrough
        return (
            in_spec.format == out_spec.format
            and in_spec.width == out_spec.width
            and in_spec.height == out_spec.height
        )

    def _scales(self, in_spec, out_spec, cfg):
        if not cfg["add-borders"]:
            return 1.0, 1.0
        return letterbox_scales(in_spec.width, in_spec.height,
                                out_spec.width, out_spec.height)

    def sp_row_shardable(self, in_spec, out_spec):
        """Every geometry and format (tpuvf: identity rows are row-local,
        a resampling over H gathers its input rows and computes its band's
        output rows, the letterbox mask slices per band)."""
        return True

    def band_reach(self, in_spec, out_spec):
        """A row axis that resamples reads every input row; at identity
        rows a 4:2:0 input's LINEAR chroma row upsample reads one chroma
        row past the band (two luma rows); otherwise nothing."""
        _, scale_y = self._scales(in_spec, out_spec,
                                  dict(self.static_config(in_spec, out_spec)))
        if in_spec.height != out_spec.height or scale_y != 1.0:
            return bands.ALL
        return 2 if in_spec.format in PLANAR_YUV_FORMATS else 0

    def make_process(self, in_spec: FrameSpec, out_spec: FrameSpec, static,
                     device, band=None):
        cfg = dict(static)
        filt = NEAREST if cfg["method"] == METHOD_NEAREST else LINEAR
        scale_x, scale_y = self._scales(in_spec, out_spec, cfg)
        border = None
        if scale_x != 1.0 or scale_y != 1.0:
            border = argb_to_rgba_floats(cfg["border-color"])
        # a band computes its output rows from the input rows it is handed
        rows = None if band is None else (band.lo, band.hi, band.in_lo,
                                          band.in_hi)
        sampler = convert.plan_rgba_sampler(
            in_spec, out_spec.width, out_spec.height, device,
            filter=filt, scale_x=scale_x, scale_y=scale_y, rows=rows)
        border_plan = convert.plan_border(
            out_spec.width, out_spec.height, scale_x, scale_y, border,
            device, rows=None if band is None else (band.lo, band.hi))
        matrix_in, matrix_out = in_spec.matrix_index, out_spec.matrix_index

        def process(planes, state, params):
            rgba_q = emit(sampler(planes), matrix_in, border=border_plan)
            return convert.pack_rgba(rgba_q, out_spec.format,
                                     matrix_out), state

        return process
