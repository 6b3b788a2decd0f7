"""vftransform — flip / rotate (8 methods) / crop (port of
``tpuvf.elements.transform``).

- formats BGRA, RGBA, NV12, I420
- method enum {none, clockwise, rotate-180, counterclockwise,
  horizontal-flip, vertical-flip, upper-left-diagonal, upper-right-diagonal}
  (gstvfmetaltransform.m:79-100) and crop-top/bottom/left/right pixels
- output caps == input caps: a rotation resamples into a same-sized target
- passthrough iff method == none and every crop is 0 (m:113-127)

The UV transform is tc' = M*(tc-0.5)+0.5+offset where M folds the crop scale
*before* the rotation (metaltransformrenderer.m:265-293).  Every method's M
is diagonal or anti-diagonal, so sampling stays separable.  Two paths:

- **fast** (no crop, and a flip, a 180° turn, or a 90°/diagonal method on a
  square frame): the texcoords land on the pixel grid, so the element
  samples at identity, emits RGBA8 (K2) and flips / transposes the uint8
  stack.  Quantizing before the flip equals tpuvf's flip-then-quantize:
  quant is elementwise;
- **general**: every plane sampled LINEAR at its transformed texcoords
  through K1/K1b (``convert.plan_texcoord_sampler``; anti-diagonal methods
  transpose the plane first), then K2 with the void border: out-of-[0,1]
  texcoords are opaque black (metaltransform_shaders.h:67-111), an outer
  product of a row and a column mask, which is K2's letterbox border.

Under sp row sharding a band is handed every input row: the fast path
flips or transposes the frame and keeps its band's rows, the general path
samples only its output rows (the row texcoords and the void mask sliced to
the band).
"""

from __future__ import annotations

import numpy as np
import torch

from tpuvf_torch.core.element import Element
from tpuvf_torch.core.formats import CORE_FORMATS, RGB_FORMATS
from tpuvf_torch.core.properties import PropertyDescriptor
from tpuvf_torch.core.registry import register
from tpuvf_torch.core.spec import FrameSpec
from tpuvf_torch.kernels import convert
from tpuvf_torch.kernels.emit import Border, emit
from tpuvf_torch.parallel import bands

METHODS = (
    ("none", 0),
    ("clockwise", 1),
    ("rotate-180", 2),
    ("counterclockwise", 3),
    ("horizontal-flip", 4),
    ("vertical-flip", 5),
    ("upper-left-diagonal", 6),
    ("upper-right-diagonal", 7),
)

# Column-major [m00, m10, m01, m11] from build_uv_transform
# (metaltransformrenderer.m:44-104); here stored row-major 2x2.
_UV_MATS = {
    0: np.array([[1, 0], [0, 1]], np.float64),
    1: np.array([[0, 1], [-1, 0]], np.float64),   # 90R: srcU=f(v), srcV=f(u)
    2: np.array([[-1, 0], [0, -1]], np.float64),  # 180
    3: np.array([[0, -1], [1, 0]], np.float64),   # 90L
    4: np.array([[-1, 0], [0, 1]], np.float64),   # horizontal flip
    5: np.array([[1, 0], [0, -1]], np.float64),   # vertical flip
    6: np.array([[0, 1], [1, 0]], np.float64),    # transpose
    7: np.array([[0, -1], [-1, 0]], np.float64),  # anti-transpose
}

_CROPS = ("crop-left", "crop-right", "crop-top", "crop-bottom")
_VOID = (0.0, 0.0, 0.0, 1.0)  # opaque black outside the source


def uv_transform_params(method, crop_l, crop_r, crop_t, crop_b, w, h):
    """Combined 2x2 matrix (row-major) + offset, crop folded before rotation
    (metaltransformrenderer.m:265-293)."""
    cl, cr = crop_l / w, crop_r / w
    ct, cb = crop_t / h, crop_b / h
    scale = np.array([1.0 - cl - cr, 1.0 - ct - cb])
    coff = np.array([(cl - cr) * 0.5, (ct - cb) * 0.5])
    m = _UV_MATS[method]
    combined = m * scale[None, :]  # columns scaled: M @ diag(scale)
    offset = m @ coff
    return combined, offset


def _fast_layout_op(method: int, w: int, h: int):
    """Pure layout equivalents (flip / transpose) over (..., C, H, W) when
    the sampled texcoords land exactly on the pixel grid: flips always do;
    90° rotations and diagonals when the frame is square.  None otherwise."""
    if method == 4:  # horizontal flip
        return lambda a: torch.flip(a, (-1,))
    if method == 5:  # vertical flip
        return lambda a: torch.flip(a, (-2,))
    if method == 2:  # 180
        return lambda a: torch.flip(a, (-2, -1))
    if w != h:
        return None
    if method == 1:  # 90 clockwise: out(r, c) = in(N-1-c, r)
        return lambda a: torch.flip(a.transpose(-1, -2), (-1,))
    if method == 3:  # 90 counter-clockwise
        return lambda a: torch.flip(a.transpose(-1, -2), (-2,))
    if method == 6:  # transpose
        return lambda a: a.transpose(-1, -2).contiguous()
    if method == 7:  # anti-transpose
        return lambda a: torch.flip(a.transpose(-1, -2), (-2, -1))
    return None


@register
class Transform(Element):
    ELEMENT_NAME = "vftransform"
    ALIASES = ("vfmetaltransform", "transform")
    KLASS = "Filter/Effect/Video"
    DESCRIPTION = "Rotates, flips and crops video frames"
    IN_FORMATS = CORE_FORMATS
    OUT_FORMATS = CORE_FORMATS
    PROPERTIES = (
        PropertyDescriptor("method", "enum", 0, "Transform method",
                           enum_values=METHODS),
        PropertyDescriptor("crop-top", "int", 0, "Pixels to crop from top",
                           0, 2**31 - 1),
        PropertyDescriptor("crop-bottom", "int", 0, "Pixels to crop from bottom",
                           0, 2**31 - 1),
        PropertyDescriptor("crop-left", "int", 0, "Pixels to crop from left",
                           0, 2**31 - 1),
        PropertyDescriptor("crop-right", "int", 0, "Pixels to crop from right",
                           0, 2**31 - 1),
    )

    def is_passthrough(self, in_spec, out_spec):
        return self.props.get("method") == 0 and all(
            self.props.get(k) == 0 for k in _CROPS)

    def sp_row_shardable(self, in_spec, out_spec):
        """Every method (tpuvf: a flip or rotation gathers the frame's rows
        and keeps its band's, the samplers compute their band's output
        rows, the void mask slices per band)."""
        return True

    def make_process(self, in_spec: FrameSpec, out_spec: FrameSpec, static,
                     device, band=None):
        cfg = dict(static)
        method = cfg["method"]
        w, h = in_spec.width, in_spec.height
        matrix_in, matrix_out = in_spec.matrix_index, out_spec.matrix_index
        rgb_in = in_spec.format in RGB_FORMATS
        no_crop = all(cfg[k] == 0 for k in _CROPS)
        fast = _fast_layout_op(method, w, h) if no_crop else None
        # a band is handed every input row and keeps its output rows
        if fast is not None:
            sampler = None if rgb_in else convert.plan_rgba_sampler(
                in_spec, w, h, device)

            def process_fast(planes, state, params):
                # RGB at identity: the planes are their own RGBA8 emit
                rgba_q = (planes["rgba"] if rgb_in
                          else emit(sampler(planes), matrix_in))
                rgba_q = fast(rgba_q)
                if band is not None:
                    rgba_q = bands.shard_rows(rgba_q, band).contiguous()
                return convert.pack_rgba(rgba_q, out_spec.format,
                                         matrix_out), state

            return process_fast

        mat, off = uv_transform_params(
            method, cfg["crop-left"], cfg["crop-right"], cfg["crop-top"],
            cfg["crop-bottom"], w, h)
        anti = mat[0, 0] == 0 and (mat[0, 1] != 0 or mat[1, 0] != 0)
        # output-grid texcoords
        u = (np.arange(w, dtype=np.float64) + 0.5) / w
        v = (np.arange(h, dtype=np.float64) + 0.5) / h
        if not anti:
            src_u = mat[0, 0] * (u - 0.5) + 0.5 + off[0]  # per output column
            src_v = mat[1, 1] * (v - 0.5) + 0.5 + off[1]  # per output row
            t_rows, t_cols = src_v, src_u
        else:
            src_u = mat[0, 1] * (v - 0.5) + 0.5 + off[0]  # per output row
            src_v = mat[1, 0] * (u - 0.5) + 0.5 + off[1]  # per output column
            t_rows, t_cols = src_u, src_v
        # fragment black-out: a transformed texcoord outside [0, 1]
        in_rows = (t_rows >= 0.0) & (t_rows <= 1.0)
        in_cols = (t_cols >= 0.0) & (t_cols <= 1.0)
        border = None
        if band is not None:  # a band samples its output rows
            in_rows = bands.shard_rows(in_rows, band, axis=0)
            t_rows = bands.shard_rows(t_rows, band, axis=0)
        if not (in_rows.all() and in_cols.all()):
            border = Border(
                torch.from_numpy(np.ascontiguousarray(in_rows)).to(device),
                torch.from_numpy(in_cols).to(device), _VOID)

        def plane_sampler(pw, ph):
            return convert.plan_texcoord_sampler(pw, ph, t_rows, t_cols,
                                                 device, transpose=anti)

        if rgb_in:
            sample_rgba = plane_sampler(w, h)

            def to_src(planes):
                return {"rgba": sample_rgba(planes["rgba"])}
        else:
            sample_y = plane_sampler(w, h)
            sample_c = plane_sampler((w + 1) // 2, (h + 1) // 2)

            def to_src(planes):
                uv = sample_c(torch.stack((planes["u"], planes["v"])))
                return {"y": sample_y(planes["y"]), "u": uv[0], "v": uv[1]}

        def process(planes, state, params):
            rgba_q = emit(to_src(planes), matrix_in, border=border)
            return convert.pack_rgba(rgba_q, out_spec.format,
                                     matrix_out), state

        return process
