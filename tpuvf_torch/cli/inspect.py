"""vf-inspect — element introspection, the gst-inspect-1.0 analog (port of
``tpuvf.cli.inspect``).

    python -m tpuvf_torch.cli.inspect              # every element factory
    python -m tpuvf_torch.cli.inspect vfcompositor # one factory's details

The reference test suites grep `gst-inspect-1.0 <element>` output for
property names, types, ranges and flags (tests/test-videofilter.sh:67-97).
This prints the same lines from the port's property descriptors, in
tpuvf's format, so the text equals tpuvf's for every factory: where the
port's own `DESCRIPTION` names how it implements an element (vfcompositor,
vfconvertscale), the Description line is tpuvf's, the text the reference
greps were written against.  Nothing here touches a device.
"""

from __future__ import annotations

import sys

from tpuvf_torch.core import registry
from tpuvf_torch.core.element import SinkElement, SourceElement


# Ancestry of the reference element each of ours mirrors (what the reference
# suites' gst-inspect greps look for — e.g. 'GstVideoFilter',
# test-videofilter.sh:97)
_GST_ANCESTRY = {
    "vfconvertscale": ("GstObject", "GstElement", "GstBaseTransform"),
    "vfvideofilter": ("GstObject", "GstElement", "GstBaseTransform",
                      "GstVideoFilter"),
    "vftransform": ("GstObject", "GstElement", "GstBaseTransform",
                    "GstVideoFilter"),
    "vfdeinterlace": ("GstObject", "GstElement", "GstBaseTransform",
                      "GstVideoFilter"),
    "vfoverlay": ("GstObject", "GstElement", "GstBaseTransform",
                  "GstVideoFilter"),
    "vfcompositor": ("GstObject", "GstElement", "GstAggregator",
                     "GstVideoAggregator"),
    "vfvideosink": ("GstObject", "GstElement", "GstBaseSink", "GstVideoSink"),
}
_GST_IFACES = {
    "vfcompositor": ("GstChildProxy",),
    "vfvideosink": ("GstVideoOverlay", "GstNavigation"),
}
# tpuvf's Description where the port's class describes its own kernels
_TPUVF_DESCRIPTION = {
    "vfcompositor": "Composites multiple video streams on the MXU",
    "vfconvertscale": "Converts video format and scales using the MXU",
}


def _description(cls) -> str:
    return _TPUVF_DESCRIPTION.get(cls.ELEMENT_NAME, cls.DESCRIPTION)


def _type_name(d):
    return {
        "float": "Double", "int": "Integer", "uint": "Unsigned Integer",
        "bool": "Boolean", "enum": "Enum", "string": "String",
        "color": "Unsigned Integer",
    }[d.type]


def format_element(cls) -> str:
    lines = []
    lines.append("Factory Details:")
    lines.append(f"  Name                     {cls.ELEMENT_NAME}")
    if cls.ALIASES:
        lines.append(f"  Aliases                  {', '.join(cls.ALIASES)}")
    lines.append(f"  Klass                    {cls.KLASS}")
    lines.append(f"  Description              {_description(cls)}")
    lines.append("")
    # ancestry of the reference element each class mirrors (the gst-inspect
    # output the reference test suites grep for), then the local classes
    gst_ancestry = _GST_ANCESTRY.get(cls.ELEMENT_NAME)
    lines.append("Object Hierarchy:")
    depth = 0
    if gst_ancestry:
        for name in gst_ancestry:
            lines.append("  " + "  " * depth + name)
            depth += 1
    bases = [b.__name__ for b in cls.__mro__ if b.__name__ not in ("object",)]
    for b in reversed(bases):
        lines.append("  " + "  " * depth + b)
        depth += 1
    ifaces = _GST_IFACES.get(cls.ELEMENT_NAME)
    if ifaces:
        lines.append("")
        lines.append("Implemented Interfaces (reference-API analogs):")
        for i in ifaces:
            lines.append(f"  {i}")
    lines.append("")
    if cls.IN_FORMATS or cls.OUT_FORMATS:
        lines.append("Pad Templates:")
        if cls.IN_FORMATS and not issubclass(cls, SourceElement):
            lines.append("  SINK template: 'sink'")
            lines.append("    Capabilities: video/x-raw")
            lines.append(
                "      format: { " + ", ".join(f.value for f in cls.IN_FORMATS) + " }")
        if cls.OUT_FORMATS and not issubclass(cls, SinkElement):
            lines.append("  SRC template: 'src'")
            lines.append("    Capabilities: video/x-raw")
            lines.append(
                "      format: { " + ", ".join(f.value for f in cls.OUT_FORMATS) + " }")
        lines.append("")
    lines.append("Element Properties:")
    for d in cls.PROPERTIES:
        flags = ["readable", "writable"]
        if d.controllable:
            flags.append("controllable")
        lines.append(f"  {d.name:<24} {d.blurb}")
        lines.append(f"                           flags: {', '.join(flags)}")
        extra = f"                           {_type_name(d)}."
        if d.minimum is not None or d.maximum is not None:
            extra += f" Range: {d.minimum} - {d.maximum}"
        extra += f" Default: {d.default}"
        lines.append(extra)
        if d.type == "enum":
            for nick, val in d.enum_values:
                lines.append(f"                           ({val}): {nick}")
    if cls.ELEMENT_NAME == "vfcompositor":
        from tpuvf_torch.elements.compositor import PAD_PROPERTIES

        lines.append("")
        lines.append("Pad Properties (sink_%u):")
        for d in PAD_PROPERTIES:
            flags = ["readable", "writable"]
            if d.controllable:
                flags.append("controllable")
            lines.append(f"  {d.name:<24} {d.blurb}")
            lines.append(f"                           flags: {', '.join(flags)}")
            lines.append(
                f"                           {_type_name(d)}. Default: {d.default}")
            if d.type == "enum":
                for nick, val in d.enum_values:
                    lines.append(f"                           ({val}): {nick}")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("Available elements:")
        for name, cls in sorted(registry.all_factories().items()):
            print(f"  {name:<22} {_description(cls)}")
        return 0
    try:
        cls = registry.lookup(argv[0])
    except KeyError:
        print(f"No such element: {argv[0]}", file=sys.stderr)
        return 1
    print(format_element(cls))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
