"""Passthrough utility elements for pipeline-string compatibility (port of
``tpuvf.elements.util_elements``).

GStreamer pipelines routinely interpose `queue` (thread boundary) and
`identity`.  The port's step runs the built stages in order on one stream,
so both are passthroughs; `tee` fans one stream out to several branches."""

from __future__ import annotations

from tpuvf_torch.core.element import Element
from tpuvf_torch.core.formats import ALL_FORMATS
from tpuvf_torch.core.properties import PropertyDescriptor
from tpuvf_torch.core.registry import register


class _Passthrough(Element):
    IN_FORMATS = ALL_FORMATS
    OUT_FORMATS = ALL_FORMATS

    def is_passthrough(self, in_spec, out_spec):
        return True


@register
class Queue(_Passthrough):
    ELEMENT_NAME = "queue"
    DESCRIPTION = "Passthrough (thread boundaries are replaced by batching)"
    PROPERTIES = (
        PropertyDescriptor("max-size-buffers", "int", 200, "ignored", 0, 2**31 - 1),
        PropertyDescriptor("max-size-bytes", "int", 10485760, "ignored", 0, 2**31 - 1),
        PropertyDescriptor("max-size-time", "int", 1000000000, "ignored", 0, 2**63 - 1),
        PropertyDescriptor("leaky", "enum", 0, "ignored",
                           enum_values=(("no", 0), ("upstream", 1),
                                        ("downstream", 2))),
    )


@register
class Identity(_Passthrough):
    ELEMENT_NAME = "identity"
    DESCRIPTION = "Passthrough"
    PROPERTIES = (
        PropertyDescriptor("silent", "bool", True, "ignored"),
    )


@register
class Tee(_Passthrough):
    """1-to-N stream fan-out (`tee name=t t. ! ... t. ! ...`).

    Every branch reads the same device planes, and each sink gets its own
    host readback.  Branch caps filters are constraints only: tee never
    converts (as in GStreamer)."""

    ELEMENT_NAME = "tee"
    DESCRIPTION = "1-to-N stream fan-out"
    FAN_OUT = True
    PROPERTIES = (
        PropertyDescriptor("allow-not-linked", "bool", False, "ignored"),
    )
