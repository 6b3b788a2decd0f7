"""Element factory registry — the plugin_init analog (port of
``tpuvf.core.registry``).

Every element class self-registers under its primary name and the same
gst-compatible aliases as in tpuvf (``vfmetalconvertscale``, ...), so pipeline
strings written for tpuvf resolve unchanged for the elements the port has.
"""

from __future__ import annotations

from typing import Dict, Type

from tpuvf_torch.core.element import Element

_REGISTRY: Dict[str, Type[Element]] = {}


def register(cls: Type[Element]) -> Type[Element]:
    names = (cls.ELEMENT_NAME,) + tuple(cls.ALIASES)
    for name in names:
        if not name:
            raise ValueError(f"{cls.__name__} has no element name")
        existing = _REGISTRY.get(name)
        if existing is not None and existing is not cls:
            raise ValueError(f"duplicate element name {name!r}")
        _REGISTRY[name] = cls
    return cls


def make(name: str, instance_name=None, **props) -> Element:
    cls = lookup(name)
    return cls(name=instance_name, **props)


def lookup(name: str) -> Type[Element]:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(
            f"no element factory {name!r}; known: {sorted(set(_REGISTRY))}"
        )
    return _REGISTRY[name]


def all_factories() -> Dict[str, Type[Element]]:
    _ensure_loaded()
    # unique classes keyed by primary name
    return {cls.ELEMENT_NAME: cls for cls in set(_REGISTRY.values())}


_loaded = False


def _ensure_loaded() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    # import for registration side effects
    import tpuvf_torch.elements  # noqa: F401
