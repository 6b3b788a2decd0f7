"""Element base classes (port of ``tpuvf.core.element``).

An Element declares its property schema and negotiation rule in Python and,
for a negotiated (in_spec, out_spec, static-config) triple, plans a per-frame
function ``process(planes, state, params) -> (planes, state)`` that runs
eagerly on tensors of one ``torch.device``.  Planning (tap tables, masks,
coordinate vectors) happens once in ``make_process`` and its tensors are
moved to the device there, so a frame does no host work but the launches.

State is an explicit dict (videofilter's frame counter) carried by the
runtime from one frame to the next.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from tpuvf_torch.core.formats import VideoFormat
from tpuvf_torch.core.frame import HostLayout, host_layout
from tpuvf_torch.core.properties import PropertyBag, PropertyDescriptor
from tpuvf_torch.core.spec import CapsFilter, FrameSpec

# planes dict -> (planes dict, state)
ProcessFn = Callable[[Dict, Any, Dict], Tuple[Dict, Any]]


class Element:
    """Base for 1-in/1-out transform elements."""

    ELEMENT_NAME: str = ""
    ALIASES: Tuple[str, ...] = ()
    KLASS: str = "Filter/Effect/Video"
    DESCRIPTION: str = ""
    PROPERTIES: Tuple[PropertyDescriptor, ...] = ()
    IN_FORMATS: Tuple[VideoFormat, ...] = ()
    OUT_FORMATS: Tuple[VideoFormat, ...] = ()

    def __init__(self, name: Optional[str] = None, **props):
        self.name = name or f"{self.ELEMENT_NAME}0"
        self.props = PropertyBag(self.PROPERTIES)
        for key, value in props.items():
            self.props.set(key.replace("_", "-"), value)

    # -- properties --------------------------------------------------------

    def set_property(self, name: str, value) -> None:
        self.props.set(name, value)

    def get_property(self, name: str):
        return self.props.get(name)

    # -- negotiation -------------------------------------------------------

    def accepts_format(self, fmt: VideoFormat) -> bool:
        return fmt in self.IN_FORMATS

    def transform_spec(
        self, in_spec: FrameSpec, out_filter: Optional[CapsFilter] = None
    ) -> FrameSpec:
        """Negotiate the output spec for an input spec + downstream filter.

        Default: output == input (GstVideoFilter semantics — no caps change),
        constrained by the downstream filter if it only adjusts format among
        OUT_FORMATS.
        """
        if not self.accepts_format(in_spec.format):
            raise ValueError(
                f"{self.ELEMENT_NAME}: format {in_spec.format} not supported "
                f"(accepts {[f.value for f in self.IN_FORMATS]})"
            )
        out = in_spec
        if out_filter is not None:
            out = out_filter.apply(out)
            if out.width != in_spec.width or out.height != in_spec.height:
                raise ValueError(
                    f"{self.ELEMENT_NAME}: cannot change frame size "
                    f"({in_spec.width}x{in_spec.height} -> {out.width}x{out.height})"
                )
            if out.format != in_spec.format:
                raise ValueError(
                    f"{self.ELEMENT_NAME}: cannot convert {in_spec.format} -> "
                    f"{out.format}"
                )
        return out

    # -- processing --------------------------------------------------------

    def is_passthrough(self, in_spec: FrameSpec, out_spec: FrameSpec) -> bool:
        return False

    def static_config(self, in_spec: FrameSpec, out_spec: FrameSpec):
        """Hashable snapshot of the non-traced props (selects the plan)."""
        items = []
        for n, d in self.props.descriptors.items():
            if not d.traced:
                items.append((n, self.props.get(n)))
        return tuple(sorted(items))

    def traced_params(self, device=None) -> Dict[str, torch.Tensor]:
        """Per-frame traced parameter values (controllable floats) as 0-dim
        float32 tensors on `device` (default: the CPU)."""
        out = {}
        for n, d in self.props.descriptors.items():
            if d.traced:
                out[n] = torch.tensor(float(self.props.get(n)),
                                      dtype=torch.float32, device=device)
        return out

    def init_state(self, in_spec: FrameSpec, out_spec: FrameSpec, device=None):
        return ()

    def make_process(
        self, in_spec: FrameSpec, out_spec: FrameSpec, static, device
    ) -> ProcessFn:
        raise NotImplementedError

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


class SourceElement(Element):
    """Produces frames host-side (numpy, native layout)."""

    KLASS = "Source/Video"

    def output_spec(self, out_filter: Optional[CapsFilter]) -> FrameSpec:
        raise NotImplementedError

    def generate(self, frame_index: int, spec: FrameSpec):
        """-> host-layout frame data (numpy)."""
        raise NotImplementedError

    def num_frames(self) -> Optional[int]:
        """None = unbounded; else the num-buffers limit."""
        n = self.props.get("num-buffers") if self.props.has("num-buffers") else -1
        return None if n is None or int(n) < 0 else int(n)

    # -- per-buffer timing/metadata (the GstBuffer pts + flags analog) -----

    def timestamp_offset(self) -> float:
        """Stream start time in seconds (timestamp-offset property, ns)."""
        if self.props.has("timestamp-offset"):
            return float(self.props.get("timestamp-offset")) / 1e9
        return 0.0

    def buffer_pts(self, frame_index: int, spec: FrameSpec) -> float:
        """Presentation timestamp of buffer `frame_index` in seconds.
        Default: offset + index/fps.  Must be monotonic in frame_index."""
        fps = float(spec.fps) or 25.0
        return self.timestamp_offset() + frame_index / fps

    def buffer_meta(self, frame_index: int, spec: FrameSpec) -> Dict:
        """Per-buffer flags (the GST_VIDEO_BUFFER_FLAG_* analog).  Keys:
        'tff' (field order of THIS buffer).  Sources with real per-buffer
        flags (appsrc) override."""
        return {"tff": bool(spec.tff)}


class SinkElement(Element):
    """Consumes frames host-side."""

    KLASS = "Sink/Video"
    # whether `consume` may keep the host frame it is handed past the call
    # (an appsink does): Pipeline.run then hands it arrays of its own, else
    # views of a readback buffer that a frame two later reuses
    KEEPS_PAYLOAD = True
    # whether the payload is the spec's host byte layout, so that a host
    # codec may encode it before the sink
    HOST_PAYLOAD = True

    def accepts_format(self, fmt: VideoFormat) -> bool:
        return not self.IN_FORMATS or fmt in self.IN_FORMATS

    def prepare(self, in_spec: FrameSpec):
        """Called once at negotiation; may allocate files/windows."""

    def device_payload(self, planes: Dict, spec: FrameSpec):
        """What Pipeline.run reads back of one frame for this sink, enqueued
        on the planes' device: -> (HostLayout, [device pieces]).  Default:
        the spec's host byte layout."""
        layout = HostLayout(spec)
        return layout, host_layout(planes, spec)

    def deliver(self, payload, spec: FrameSpec, frame_index: int) -> None:
        """Hand over one frame's read-back payload (after its host codecs)
        in Pipeline.run.  Default: `consume`."""
        self.consume(payload, spec, frame_index)

    def consume(self, host_frame, spec: FrameSpec, frame_index: int) -> None:
        raise NotImplementedError

    def finalize(self) -> None:
        """End-of-stream."""
