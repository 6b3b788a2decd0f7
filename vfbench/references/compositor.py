"""The reference of a ``compositor`` configuration: the pads in order over
the background on an RGBA8 canvas, each draw premultiplied by its alpha,
blended by its operator and quantized, then the overlay's mix.  `values`
holds the frame's scheduled pad properties ("sink_1::xpos": 640, ...)."""

from __future__ import annotations

import numpy as np
import torch

from vfbench.reference import OPERATORS


def frame(r, ref: dict, frames: dict, values: dict):
    out = ref["output"]
    W, H = out["width"], out["height"]
    canvas = [torch.full((H, W), int(v), dtype=torch.uint8, device=r.device)
              for v in ref["background"]]
    one = r.const(1.0)
    for pad in ref["pads"]:
        p = {k: values.get(f"{pad['pad']}::{k}", pad[k])
             for k in ("xpos", "ypos", "alpha", "operator")}
        src = ref["sources"][pad["source"]]
        w, h = src["width"], src["height"]
        px, py = int(p["xpos"]), int(p["ypos"])
        x0, y0 = max(px, 0), max(py, 0)
        x1, y1 = min(px + w, W), min(py + h, H)
        if x1 <= x0 or y1 <= y0:
            continue
        s = r.source_rgba(frames[pad["source"]], src["format"], w, h)
        s = [c[y0 - py:y1 - py, x0 - px:x1 - px] for c in s]
        sa = s[3] * r.const(float(np.float32(p["alpha"])))
        sp = [c * sa for c in s[:3]] + [sa]
        op = p["operator"]
        op = OPERATORS[op] if isinstance(op, str) else int(op)
        for c in range(4):
            dv = r.dequant(canvas[c][y0:y1, x0:x1])
            if op == OPERATORS["source"]:
                blended = sp[c]
            elif op == OPERATORS["add"]:
                blended = sp[c] + dv
            else:
                blended = sp[c] + dv * (one - sa)
            canvas[c][y0:y1, x0:x1] = r.quant(blended)
    if ref.get("overlay"):
        canvas = r.overlay(canvas, ref["overlay"])
    return r.host_layout(canvas, out["format"])
