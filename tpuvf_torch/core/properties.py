"""Typed property descriptors — the framework's GObject-property analog.

The reference's de-facto element schema is its GParamSpec table (name, type,
range, default, CONTROLLABLE flag — e.g. gstvfmetalvideofilter.m:435-533).
Here that schema is explicit data: each element class declares a tuple of
PropertyDescriptor; the same registry drives value validation, gst-launch
style string parsing, introspection, and the split between *traced*
parameters (per-frame float scalars, carried as 0-dim float32 tensors on the
device) and *static* parameters (enums/ints that select the planned code
path).  A copy of ``tpuvf.core.properties``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class PropertyDescriptor:
    name: str
    type: str  # 'float' | 'int' | 'uint' | 'bool' | 'enum' | 'string' | 'color'
    default: Any
    blurb: str = ""
    minimum: Any = None
    maximum: Any = None
    enum_values: Tuple[Tuple[str, int], ...] = ()  # ((nick, value), ...)
    controllable: bool = False
    # traced=True: value is fed to the per-frame process as a 0-dim float32
    # tensor.  traced=False: value selects the planned code path (method
    # enums, sizes) and changing it rebuilds the pipeline.
    traced: bool = False

    def parse(self, text: str) -> Any:
        t = text.strip().strip('"')
        if self.type == "float":
            return float(t)
        if self.type in ("int", "uint"):
            return int(t, 0)
        if self.type == "color":
            return int(t, 0) & 0xFFFFFFFF
        if self.type == "bool":
            low = t.lower()
            if low in ("true", "1", "yes"):
                return True
            if low in ("false", "0", "no"):
                return False
            raise ValueError(f"bad boolean {text!r} for {self.name}")
        if self.type == "enum":
            for nick, val in self.enum_values:
                if t == nick or t == str(val):
                    return val
            raise ValueError(
                f"bad enum {text!r} for {self.name}; "
                f"one of {[n for n, _ in self.enum_values]}"
            )
        if self.type == "string":
            return t
        raise ValueError(f"unknown property type {self.type}")

    def validate(self, value: Any) -> Any:
        """GParamSpec-style validation: clamp numeric ranges, check enums."""
        if self.type == "float":
            value = float(value)
            if self.minimum is not None:
                value = max(value, self.minimum)
            if self.maximum is not None:
                value = min(value, self.maximum)
            return value
        if self.type in ("int", "uint"):
            value = int(value)
            if self.type == "uint" and value < 0:
                value = 0
            if self.minimum is not None:
                value = max(value, self.minimum)
            if self.maximum is not None:
                value = min(value, self.maximum)
            return value
        if self.type == "color":
            return int(value) & 0xFFFFFFFF
        if self.type == "bool":
            return bool(value)
        if self.type == "enum":
            allowed = {v for _, v in self.enum_values}
            value = int(value)
            if value not in allowed:
                raise ValueError(f"{self.name}: enum value {value} not in {allowed}")
            return value
        if self.type == "string":
            return None if value is None else str(value)
        raise ValueError(f"unknown property type {self.type}")

    def enum_nick(self, value: int) -> str:
        for nick, val in self.enum_values:
            if val == value:
                return nick
        return str(value)


class PropertyBag:
    """Holds live property values for an element instance."""

    def __init__(self, descriptors: Tuple[PropertyDescriptor, ...]):
        self._desc: Dict[str, PropertyDescriptor] = {d.name: d for d in descriptors}
        self._values: Dict[str, Any] = {d.name: d.default for d in descriptors}

    @property
    def descriptors(self) -> Dict[str, PropertyDescriptor]:
        return self._desc

    def has(self, name: str) -> bool:
        return name in self._desc

    def set(self, name: str, value: Any) -> None:
        if name not in self._desc:
            raise KeyError(f"no such property {name!r}")
        self._values[name] = self._desc[name].validate(value)

    def set_from_string(self, name: str, text: str) -> None:
        if name not in self._desc:
            raise KeyError(f"no such property {name!r}")
        self.set(name, self._desc[name].parse(text))

    def get(self, name: str) -> Any:
        return self._values[name]

    def snapshot(self) -> Dict[str, Any]:
        """Per-frame property snapshot (the GST_OBJECT_LOCK copy analog)."""
        return dict(self._values)

    def at_defaults(self, names=None, eps: float = 1e-6) -> bool:
        """True iff every (selected) property equals its default — the
        passthrough test (FLOAT_EQ, gstvfmetalvideofilter.m:114-138)."""
        for n, d in self._desc.items():
            if names is not None and n not in names:
                continue
            v = self._values[n]
            if d.type == "float":
                if abs(v - d.default) > eps:
                    return False
            elif v != d.default:
                return False
        return True


def argb_to_rgba_floats(argb: int) -> tuple:
    """0xAARRGGBB -> (r, g, b, a) floats in [0,1] (border-color/chroma-key
    property convention, gstvfmetalconvertscale.m:62-72)."""
    a = ((argb >> 24) & 0xFF) / 255.0
    r = ((argb >> 16) & 0xFF) / 255.0
    g = ((argb >> 8) & 0xFF) / 255.0
    b = (argb & 0xFF) / 255.0
    return (r, g, b, a)
