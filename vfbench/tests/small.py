"""Small copies of the configurations, for the tests on the CPU: the same
launch descriptions and reference descriptions at a twentieth of the size
(the overlay at 16x16), and the cells built from them."""

from __future__ import annotations

import copy
import json
import re

from vfbench import spec

SIZES = {3840: 192, 2160: 108, 1920: 96, 1080: 54, 1280: 64, 720: 36,
         256: 16, 128: 8}


def _scale_launch(desc: str) -> str:
    def sub(m):
        return f"{m.group(1)}={SIZES[int(m.group(2))]}"
    return re.sub(r"\b(width|height|xpos|ypos|x|y)=(\d+)", sub, desc)


def _scale(obj):
    if isinstance(obj, dict):
        return {k: (SIZES.get(v, v) if k in ("width", "height", "xpos",
                                             "ypos", "x", "y", "from", "to")
                    and isinstance(v, int) else _scale(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_scale(v) for v in obj]
    return obj


def config(name: str) -> dict:
    with open(spec.HERE / "configs" / f"{name}.json") as fh:
        cfg = json.load(fh)
    cfg = copy.deepcopy(cfg)
    cfg["launch"] = _scale_launch(cfg["launch"])
    cfg["reference"] = _scale(cfg["reference"])
    return cfg


def traffic(name: str) -> dict:
    with open(spec.traffic_path(name)) as fh:
        return _scale(json.load(fh))


def cell(config_name: str, traffic_name: str, end_to_end=(), per_layer=()):
    return spec.Cell(f"{config_name}.{traffic_name}", 1, config(config_name),
                     traffic(traffic_name), list(end_to_end), list(per_layer))
