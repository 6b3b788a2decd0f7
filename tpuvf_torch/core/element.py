"""Element base classes (port of ``tpuvf.core.element``).

An Element declares its property schema and negotiation rule in Python and,
for a negotiated (in_spec, out_spec, static-config) triple, plans a per-frame
function ``process(planes, state, params) -> (planes, state)`` that runs
eagerly on tensors of one ``torch.device``.  Planning (tap tables, masks,
coordinate vectors) happens once in ``make_process`` and its tensors are
moved to the device there, so a frame does no host work but the launches.

State is an explicit dict (videofilter's frame counter) carried by the
runtime from one frame to the next.

Per-frame property control (the GstController analog, tpuvf's
``Element.control``): a schedule attached to a property is applied before
every frame by `sync_frame`, which `Pipeline.run` and `Pipeline.run_batched`
call with the output clock's frame index, so a ramp animates the same way
under both.
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
        # per-frame property schedules: name -> callable(frame) -> value, or
        # a sequence indexed by frame
        self._controllers = {}
        for key, value in props.items():
            self.props.set(key.replace("_", "-"), value)

    # -- properties --------------------------------------------------------

    def set_property(self, name: str, value) -> None:
        self.props.set(name, value)

    def get_property(self, name: str):
        return self.props.get(name)

    # -- per-frame property control (tpuvf/core/element.py:73-159) ----------

    def control(self, name: str, values,
                allow_structure_change: bool = False) -> None:
        """Attach (or with values=None clear) a per-frame schedule for a
        property: a callable(frame_index) -> value, or a sequence indexed by
        the output clock's frame index (its last entry once exhausted).

        A sequence is checked here: a value that flips a static effect gate
        or the passthrough state against frame 0's raises at once, naming
        the frame, since `Pipeline.run_batched` keeps one structure per
        call.  Pass allow_structure_change=True for `Pipeline.run`, which
        rebuilds per frame; a callable cannot be enumerated and is checked
        at dispatch."""
        if not self._ctl_has(name):
            raise KeyError(f"no such property {name!r}")
        if values is None:
            self._controllers.pop(name, None)
            return
        if not callable(values):
            values = list(values)
            if not values:
                raise ValueError(f"empty schedule for {name!r}")
            if not allow_structure_change:
                self._ctl_validate_schedule(name, values)
        self._controllers[name] = values

    def _ctl_validate_schedule(self, name: str, values) -> None:
        """Raise at the first scheduled frame whose structure differs from
        frame 0's; the property keeps its value."""
        saved = self._ctl_get(name)
        try:
            self._ctl_set(name, values[0])
            base = self._ctl_probe()
            if base is None:  # not probeable without specs
                return
            for i, v in enumerate(values[1:], start=1):
                self._ctl_set(name, v)
                if self._ctl_probe() != base:
                    raise ValueError(
                        f"schedule for {name!r} changes pipeline structure "
                        f"at frame {i} (value {v!r} flips a static effect "
                        f"gate or the passthrough state vs frame 0's "
                        f"{values[0]!r}) — one run_batched call keeps one "
                        f"structure.  Keep the schedule on one side of the "
                        f"gate, split it across run_batched calls, or pass "
                        f"allow_structure_change=True and use run() "
                        f"(rebuilds per frame)")
        finally:
            self._ctl_set(name, saved)

    def _ctl_probe(self):
        """Spec-free structural fingerprint for `control`; None when the
        structure needs negotiated specs (checked at dispatch then)."""
        try:
            static = self.static_config(None, None)
        except Exception:  # noqa: BLE001 - any failure means "not probeable"
            return None
        return (static, self.props.at_defaults())

    # schedule targets: an element whose targets are not its own props (the
    # compositor's "sink_0::xpos") overrides these three

    def _ctl_has(self, name: str) -> bool:
        return self.props.has(name)

    def _ctl_get(self, name: str):
        return self.props.get(name)

    def _ctl_set(self, name: str, value) -> None:
        self.set_property(name, value)

    def sync_frame(self, frame: int) -> None:
        """Apply every controlled property's value for output frame
        `frame` (the gst_object_sync_values analog)."""
        for name, values in self._controllers.items():
            if callable(values):
                v = values(frame)
            else:
                v = values[min(frame, len(values) - 1)]
            self._ctl_set(name, v)

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

    def traced_values(self, device=None) -> Tuple[Dict[str, float], Dict]:
        """This frame's traced parameters, read on the host: (scalars the
        step reads on the device, as Python floats, {name: float}; values
        handed over as they are, such as a table already on `device` or
        host numbers).  `Pipeline` stages the scalars on the device only
        when one changed (`runtime/staging.py`)."""
        return ({n: float(self.props.get(n))
                 for n, d in self.props.descriptors.items() if d.traced}, {})

    def traced_params(self, device=None) -> Dict:
        """Per-frame traced parameters: the scalars of `traced_values` as
        0-dim float32 tensors on `device` (default: the CPU), and its other
        values as they are."""
        scalars, other = self.traced_values(device)
        out = {k: torch.tensor(v, dtype=torch.float32, device=device)
               for k, v in scalars.items()}
        out.update(other)
        return out

    def init_state(self, in_spec: FrameSpec, out_spec: FrameSpec, device=None):
        return ()

    def make_process(
        self, in_spec: FrameSpec, out_spec: FrameSpec, static, device,
        band=None,
    ) -> ProcessFn:
        """Plan the frame's process on `device`.  With `band` (a
        ``parallel.bands.Band``, only for an element that answers
        `sp_row_shardable`) the process is handed the input rows
        ``[band.in_lo, band.in_hi)`` of each plane (and of its plane-shaped
        state) and returns the output rows ``[band.lo, band.hi)``; its
        tables are the frame's, sliced to those rows."""
        raise NotImplementedError

    # -- dp/sp sharding (tpuvf/core/element.py:258-284) ---------------------

    def dp_shard_safe(self, in_spec: FrameSpec, out_spec: FrameSpec) -> bool:
        """Whether the output does not depend on cross-frame state, so one
        stream may be batch-split across dp shards, each with its own
        history.  An element whose carried state feeds its output
        (vfdeinterlace weave/greedy-H, vfvideofilter's grain counter)
        answers False, and ``run_batched(mesh=...)`` then needs
        ``independent_streams=True``."""
        return True

    def sp_row_shardable(self, in_spec: FrameSpec,
                         out_spec: FrameSpec) -> bool:
        """Whether the element runs on a row band of its planes under
        ``run_batched(mesh, sp_axis=...)`` (tpuvf's predicate as it answers
        for builds with no phase links).  False by default; run_batched then
        refuses the sp request."""
        return False

    def band_reach(self, in_spec: FrameSpec, out_spec: FrameSpec):
        """Input rows a band's build reads past the band on each interior
        side: the element's whole vertical reach, rounded up to even rows
        (0 for a row-local element), or ``bands.ALL`` (None) where the
        output rows depend on rows anywhere in the frame (a resampling
        over H, a rotation)."""
        return None

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

    def payload_key(self):
        """What `device_payload`'s plan depends on beyond the spec, hashable
        (None: nothing).  A compiled step drops its graphs when it changes
        (``runtime/compiled.py``)."""
        return None

    def deliver(self, payload, spec: FrameSpec, frame_index: int) -> None:
        """Hand over one frame's read-back payload (after its host codecs)
        in Pipeline.run.  Default: `consume`."""
        self.consume(payload, spec, frame_index)

    def consume(self, host_frame, spec: FrameSpec, frame_index: int) -> None:
        raise NotImplementedError

    def finalize(self) -> None:
        """End-of-stream."""
