"""vfvideosink — display sink with aspect-fit letterboxing and navigation
(port of ``tpuvf.elements.videosink``).

The reference renders into a CAMetalLayer; the port renders the same
aspect-fit letterboxed "drawable" (gst_video_center_rect) into an RGBA
window buffer, ``window`` ((H, W, 4) uint8 numpy), that an application can
read or dump to numbered PNG files (``snapshot-location``).

- props force-aspect-ratio=TRUE, enable-navigation-events=TRUE,
  window-width/-height (0 = the video's), snapshot-location;
- aspect-fit display rect with black letterbox bars (alpha 255);
  force-aspect-ratio=false stretches to the full window or render rect;
- GstVideoOverlay analog: set_window_size / set_render_rectangle / expose;
- GstNavigation analog: navigation_to_video_coords maps pointer coords from
  window space into video pixel space (clamped), send_navigation_event.

The render runs on the planes' device through the port's kernels:
`to_rgba` at the source size (K1/K1b bring a YUV input's chroma to the luma
grid, K2 emits float32 RGBA), the LINEAR resample of that float RGBA to the
display rect (K1 rows, then K1b columns), `quant`, and the placement into
the window.  Where the display rect is the video's size the resample is the
identity and K2 emits the RGBA8 values directly (the same values: K2's
uint8 emit is the quantized float emit).  Inside `Pipeline.run` the sink
renders the step's device planes (`device_payload`) and only the window
buffer is read back; `consume` (a host frame handed over outside a run)
uploads the frame first, as tpuvf's consume does, to the sink's device:
"cuda" unless the caller asks for the CPU (``VideoSink(device="cpu")`` or
`bind_device`).  Navigation routing into a compositor's pads is not
ported.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tpuvf_torch.core.element import SinkElement
from tpuvf_torch.core.formats import CORE_FORMATS
from tpuvf_torch.core.frame import HostLayout, from_host_layout
from tpuvf_torch.core.properties import PropertyDescriptor
from tpuvf_torch.core.registry import register
from tpuvf_torch.core.spec import FrameSpec
from tpuvf_torch.kernels import convert
from tpuvf_torch.kernels.color import quant
from tpuvf_torch.kernels.emit import emit
from tpuvf_torch.kernels.resample import resample_cols, resample_rows
from tpuvf_torch.kernels.sample import LINEAR
from tpuvf_torch.runtime.device import get_device


def center_rect(src_w, src_h, dst_w, dst_h, scaling=True):
    """gst_video_center_rect: aspect-fit src into dst, centered."""
    if not scaling:
        w, h = min(src_w, dst_w), min(src_h, dst_h)
    else:
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


@register
class VideoSink(SinkElement):
    ELEMENT_NAME = "vfvideosink"
    # autovideosink: the auto-pick resolves to the one windowed sink
    ALIASES = ("vfmetalvideosink", "videosink", "autovideosink")
    KLASS = "Sink/Video"
    DESCRIPTION = "Renders video into a window buffer with aspect-fit scaling"
    IN_FORMATS = CORE_FORMATS
    PROPERTIES = (
        PropertyDescriptor("force-aspect-ratio", "bool", True,
                           "Keep the display aspect ratio"),
        PropertyDescriptor("enable-navigation-events", "bool", True,
                           "Forward pointer/keyboard events upstream"),
        PropertyDescriptor("window-width", "int", 0,
                           "Window width (0 = video width)", 0, 2**31 - 1),
        PropertyDescriptor("window-height", "int", 0,
                           "Window height (0 = video height)", 0, 2**31 - 1),
        PropertyDescriptor("snapshot-location", "string", None,
                           "Write frames as PNG files to this printf pattern "
                           "(e.g. /tmp/frame-%04d.png)"),
    )

    HOST_PAYLOAD = False  # the window buffer, rendered on the device

    def __init__(self, *a, device="cuda", **k):
        super().__init__(*a, **k)
        self.window: Optional[np.ndarray] = None  # (H, W, 4) RGBA
        self.frame_count = 0
        # where `consume` renders a host frame; resolved at that call, so a
        # sink built for a CPU pipeline needs no card
        self.device = device
        self._spec: Optional[FrameSpec] = None
        self._display_rect: Optional[Tuple[int, int, int, int]] = None
        self._render = None  # (device, render function)
        self._render_rectangle = None
        self._last_planes = None  # device planes of the last frame (expose)
        self.navigation_callback: Optional[Callable] = None

    def bind_device(self, device) -> None:
        """Render the host frames handed to `consume` on `device`."""
        self.device = device

    # -- GstVideoOverlay analog ------------------------------------------

    def set_window_size(self, width: int, height: int) -> None:
        """set_window_handle analog: embed into a window of this size."""
        self.props.set("window-width", width)
        self.props.set("window-height", height)
        self._render = None

    def set_render_rectangle(self, x, y, w, h) -> None:
        self._render_rectangle = (x, y, w, h)
        self._render = None

    def expose(self) -> None:
        """Re-present the last frame through the current window/render
        rectangle: after set_render_rectangle or set_window_size the window
        buffer refreshes without a new buffer arriving.  No-op when nothing
        has been rendered yet."""
        if self._last_planes is None or self._spec is None:
            return
        self.window = self.render_device(self._last_planes,
                                         self._spec).cpu().numpy()

    # -- GstNavigation analog --------------------------------------------

    def navigation_to_video_coords(self, wx: float, wy: float):
        """Window coords -> video pixel coords (renderer m:690-703)."""
        if self._display_rect is None or self._spec is None:
            return wx, wy
        dx, dy, dw, dh = self._display_rect
        vx = (wx - dx) * self._spec.width / max(dw, 1)
        vy = (wy - dy) * self._spec.height / max(dh, 1)
        vx = min(max(vx, 0.0), float(self._spec.width))
        vy = min(max(vy, 0.0), float(self._spec.height))
        return vx, vy

    def send_navigation_event(self, event: str, wx: float, wy: float):
        if not self.props.get("enable-navigation-events"):
            return None
        vx, vy = self.navigation_to_video_coords(wx, wy)
        ev = {"event": event, "pointer_x": vx, "pointer_y": vy}
        if self.navigation_callback:
            self.navigation_callback(ev)
        return ev

    # -- rendering --------------------------------------------------------

    def prepare(self, in_spec: FrameSpec):
        self._spec = in_spec

    def window_shape(self, spec: FrameSpec) -> Tuple[int, int, int]:
        """(H, W, 4) of the window buffer for a stream of `spec`."""
        return (self.props.get("window-height") or spec.height,
                self.props.get("window-width") or spec.width, 4)

    def _build_render(self, spec: FrameSpec, dev: torch.device):
        win_h, win_w, _ = self.window_shape(spec)
        if self._render_rectangle is not None:
            rx, ry, rw, rh = self._render_rectangle
        else:
            rx, ry, rw, rh = 0, 0, win_w, win_h
        if self.props.get("force-aspect-ratio"):
            dx, dy, dw, dh = center_rect(spec.width, spec.height, rw, rh)
        else:
            dx, dy, dw, dh = 0, 0, rw, rh
        dx, dy = dx + rx, dy + ry
        self._display_rect = (dx, dy, dw, dh)
        mi = spec.matrix_index
        to_rgba = convert.plan_rgba_sampler(spec, spec.width, spec.height, dev)
        taps_y = convert.plan_axis_taps(spec.height, dh, LINEAR, 1.0, dev)
        taps_x = convert.plan_axis_taps(spec.width, dw, LINEAR, 1.0, dev,
                                        cols=True)

        def render(planes) -> torch.Tensor:
            src = to_rgba(planes)
            if taps_y is None and taps_x is None:
                scaled = emit(src, mi)
            else:
                rgba = emit(src, mi, out_float=True)
                if taps_y is not None:
                    rgba = resample_rows(rgba, taps_y)
                if taps_x is not None:
                    rgba = resample_cols(rgba, taps_x)
                scaled = quant(rgba)
            # black letterbox clear (renderer m:541-560)
            window = torch.zeros((win_h, win_w, 4), dtype=torch.uint8,
                                 device=scaled.device)
            window[..., 3] = 255
            window[dy:dy + dh, dx:dx + dw] = scaled.permute(1, 2, 0)
            return window

        self._render = (dev, render)

    def payload_key(self):
        """The window and render rectangle the render plan was built for
        (a compiled step captures the plan)."""
        return (self.props.get("window-width"),
                self.props.get("window-height"),
                self.props.get("force-aspect-ratio"), self._render_rectangle)

    def render_device(self, planes, spec: FrameSpec) -> torch.Tensor:
        """The window buffer ((H, W, 4) uint8 RGBA) of one frame's canonical
        planes, rendered on their device."""
        dev = next(iter(planes.values())).device
        if (self._render is None or self._spec != spec
                or self._render[0] != dev):
            self._spec = spec
            self._build_render(spec, dev)
        self._last_planes = planes  # kept for expose() re-blits
        return self._render[1](planes)

    def device_payload(self, planes, spec: FrameSpec):
        """Pipeline.run reads back only the window buffer."""
        window = self.render_device(planes, spec)
        return HostLayout(spec, tuple(window.shape)), [window]

    def deliver(self, window: np.ndarray, spec: FrameSpec,
                frame_index: int) -> None:
        self.present(window, frame_index)

    def present(self, window: np.ndarray, frame_index: int) -> None:
        """Show a rendered window buffer (and write its snapshot)."""
        self.window = window
        self.frame_count += 1
        pattern = self.props.get("snapshot-location")
        if pattern:
            from tpuvf_torch.io import png

            path = pattern % (frame_index,) if "%" in pattern else pattern
            png.write(path, self.window)

    def consume(self, host_frame, spec: FrameSpec, frame_index: int) -> None:
        layout = HostLayout(spec)
        planes = from_host_layout(
            layout.upload(host_frame, get_device(self.device)), spec)
        self.present(self.render_device(planes, spec).cpu().numpy(),
                     frame_index)
