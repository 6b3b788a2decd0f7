"""vfoverlay — PNG/JPEG image overlay (port of ``tpuvf.elements.overlay``,
canonical path).

- formats BGRA, RGBA, NV12, I420
- props: location (PNG, or JPEG through the port's native decoder), x/y >= 0 px,
  width/height (0 = native image size), alpha [0,1]=1 (a traced scalar),
  relative-x/-y in [-1,1] default -1 — relative >= 0 overrides absolute as
  rel*frameW / rel*frameH (gstvfmetaloverlay.m:189-200, 374-420)
- passthrough iff no image is loaded; a missing or bad file warns and stays
  passthrough (m:94-99, 114-127)
- blending: video.rgb = mix(video.rgb, overlay.rgb, overlay.a * alpha)
  inside the overlay rect (metaloverlay_shaders.h:79-86) on the
  premultiplied image, resampled LINEAR when stretched

At build time the image is resampled to its rect on the host
(``overlay.overlay_rect``) and moved to the device once, with a 4:2:0
input's chroma taps (``convert.plan_chroma_taps``).  Per frame, one K6
launch (``overlay.overlay_frame``) runs the whole body: the frame's float32
RGB (the dequantized uint8 planes of an RGB input; for a 4:2:0 input the
unquantized ``yuv_to_rgb`` of its LINEAR-sampled chroma, as tpuvf blends
it), the rect blend, the RGBA8 quantization and the output pack.  After a
vfcompositor with an RGB output the pipeline folds the
overlay into the compositor's K4 launch as a final mix draw
(`fold_into_aggregate_ok`, `fold_rect`; ``tpuvf/runtime/pipeline.py:
541-606``) and this stage is a passthrough; after a YUV output it runs
here, as tpuvf runs it.  Under sp row sharding a band blends the frame's
rect clipped to its rows (`overlay.band_rect`), with a 4:2:0 input's chroma
halo.  tpuvf's split/quad/grid link bodies are TPU layouts and are not
ported.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from tpuvf_torch.core.element import Element
from tpuvf_torch.core.formats import CORE_FORMATS, RGB_FORMATS
from tpuvf_torch.core.properties import PropertyDescriptor
from tpuvf_torch.core.registry import register
from tpuvf_torch.core.spec import FrameSpec
from tpuvf_torch.io import png
from tpuvf_torch.kernels import convert
from tpuvf_torch.kernels.overlay import band_rect, overlay_frame, overlay_rect

_log = logging.getLogger("tpuvf_torch.overlay")


def load_overlay_image(path: str) -> np.ndarray:
    """-> (H, W, 4) uint8 premultiplied RGBA.  PNG via the built-in codec;
    JPEG (opaque, so premultiplied as decoded) via the native decoder."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return png.decode_premultiplied(data)
    if data[:2] == b"\xff\xd8":
        from tpuvf_torch.native import jpeg  # builds the library at first use

        return jpeg.decode(data)
    raise ValueError(f"unsupported image format in {path}")


@register
class Overlay(Element):
    ELEMENT_NAME = "vfoverlay"
    ALIASES = ("vfmetaloverlay", "overlay")
    KLASS = "Filter/Effect/Video"
    DESCRIPTION = "Blends a PNG/JPEG image over video"
    IN_FORMATS = CORE_FORMATS
    OUT_FORMATS = CORE_FORMATS
    PROPERTIES = (
        PropertyDescriptor("location", "string", None,
                           "Path to overlay image file (PNG or JPEG)"),
        PropertyDescriptor("x", "int", 0, "Overlay X position in pixels",
                           0, 2**31 - 1),
        PropertyDescriptor("y", "int", 0, "Overlay Y position in pixels",
                           0, 2**31 - 1),
        PropertyDescriptor("width", "int", 0,
                           "Overlay width in pixels (0 = original image width)",
                           0, 2**31 - 1),
        PropertyDescriptor("height", "int", 0,
                           "Overlay height in pixels (0 = original image height)",
                           0, 2**31 - 1),
        PropertyDescriptor("alpha", "float", 1.0, "Overlay opacity",
                           0.0, 1.0, controllable=True, traced=True),
        PropertyDescriptor("relative-x", "float", -1.0,
                           "X as fraction of video width (-1 = use pixel x)",
                           -1.0, 1.0),
        PropertyDescriptor("relative-y", "float", -1.0,
                           "Y as fraction of video height (-1 = use pixel y)",
                           -1.0, 1.0),
    )

    def __init__(self, *a, **k):
        self._image = None
        self._image_path_loaded = None
        super().__init__(*a, **k)

    # -- image lifecycle (load on property write, soft-fail, m:94-127) -----

    def set_property(self, name, value):
        super().set_property(name, value)
        if name == "location":
            self._reload_image()

    def _reload_image(self):
        path = self.props.get("location")
        self._image, self._image_path_loaded = None, None
        if not path:
            return
        try:
            self._image = load_overlay_image(path)
        except Exception as exc:  # noqa: BLE001 - any unreadable file soft-fails
            # missing or bad file => warning + stay passthrough (m:114-127)
            _log.warning("failed to load overlay image %s: %s", path, exc)
            return
        self._image_path_loaded = path

    def _sync_image(self):
        if self.props.get("location") != self._image_path_loaded:
            self._reload_image()

    def is_passthrough(self, in_spec, out_spec):
        self._sync_image()
        return self._image is None or in_spec.format != out_spec.format

    def static_config(self, in_spec, out_spec):
        self._sync_image()
        shape = None if self._image is None else self._image.shape[:2]
        return super().static_config(in_spec, out_spec) + (
            ("image_shape", shape),)

    def placement(self, spec: FrameSpec):
        """(ox, oy, ow, oh) of the image on a frame of `spec`
        (m:374-420)."""
        img_h, img_w = self._image.shape[:2]
        rel_x, rel_y = self.props.get("relative-x"), self.props.get("relative-y")
        ox = float(rel_x * spec.width) if rel_x >= 0.0 else float(
            self.props.get("x"))
        oy = float(rel_y * spec.height) if rel_y >= 0.0 else float(
            self.props.get("y"))
        return (ox, oy, float(self.props.get("width") or img_w),
                float(self.props.get("height") or img_h))

    def fold_into_aggregate_ok(self, in_spec, out_spec) -> bool:
        """Whether this overlay can be a final mix draw of an upstream
        compositor's fold: an image is loaded and the overlay keeps format
        and size (tpuvf/elements/overlay.py:250-260)."""
        self._sync_image()
        return (self._image is not None
                and in_spec.format == out_spec.format
                and in_spec.width == out_spec.width
                and in_spec.height == out_spec.height)

    def fold_rect(self, spec: FrameSpec):
        """-> (rect (x0, x1, y0, y1), (4, h, w) float32 planes): the
        premultiplied image resampled to its rect on a frame of `spec`
        (tpuvf's `fold_draw_config`)."""
        self._sync_image()
        return overlay_rect(self._image, spec.width, spec.height,
                            *self.placement(spec))

    # -- sp sharding (tpuvf/elements/overlay.py:230-245) -------------------

    def sp_row_shardable(self, in_spec, out_spec):
        """An image loaded, the format kept, and RGB or 4:2:0 of even width
        and height (tpuvf's canonical rule): the rect blend is row-local."""
        self._sync_image()
        if self._image is None or in_spec.format != out_spec.format:
            return False
        return (in_spec.format in RGB_FORMATS
                or convert.phase_capable(in_spec, out_spec))

    def band_reach(self, in_spec, out_spec):
        """A 4:2:0 input's LINEAR chroma row upsample (2 rows); RGB is per
        pixel."""
        return 0 if in_spec.format in RGB_FORMATS else 2

    def make_process(self, in_spec: FrameSpec, out_spec: FrameSpec, static,
                     device, band=None):
        rect, planes_np = self.fold_rect(in_spec)
        window = None
        if band is not None:
            # the frame's rect on the band's input rows
            window = (band.in_lo, band.in_hi)
            rect, planes_np = band_rect(rect, planes_np, *window)
        ov = torch.from_numpy(planes_np).to(device)
        taps = (None if in_spec.format in RGB_FORMATS
                else convert.plan_chroma_taps(in_spec, device, rows=window))
        trim = (lambda planes: planes) if band is None else band.trim
        matrix_in, matrix_out = in_spec.matrix_index, out_spec.matrix_index

        def process(planes, state, params):
            return trim(overlay_frame(planes, taps, rect, ov, params["alpha"],
                                      matrix_in, matrix_out)), state

        return process
