"""Sink elements: fakesink, appsink (port of ``tpuvf.elements.sinks``;
filesink and multifilesink are not ported yet)."""

from __future__ import annotations

from tpuvf_torch.core.element import SinkElement
from tpuvf_torch.core.properties import PropertyDescriptor
from tpuvf_torch.core.registry import register
from tpuvf_torch.core.spec import FrameSpec


@register
class FakeSink(SinkElement):
    """Discards frames (the fakesink used by every reference smoke test)."""

    ELEMENT_NAME = "fakesink"
    DESCRIPTION = "Discards all frames"
    PROPERTIES = (
        PropertyDescriptor("sync", "bool", False, "Sync on the clock"),
        PropertyDescriptor("silent", "bool", True, "Don't emit notifications"),
    )

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.frame_count = 0

    def consume(self, host_frame, spec, frame_index):
        self.frame_count += 1


@register
class AppSink(SinkElement):
    """Collects host frames for inspection from Python (appsink analog)."""

    ELEMENT_NAME = "appsink"
    DESCRIPTION = "Collects frames into memory"
    PROPERTIES = (
        PropertyDescriptor("max-buffers", "int", 0, "Keep at most N frames "
                           "(0 = all)", minimum=0, maximum=2**31 - 1),
    )

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.frames: list = []
        self.spec: FrameSpec | None = None

    def prepare(self, in_spec):
        self.spec = in_spec

    def consume(self, host_frame, spec, frame_index):
        self.spec = spec
        limit = self.props.get("max-buffers")
        self.frames.append(host_frame)
        if limit and len(self.frames) > limit:
            self.frames.pop(0)
