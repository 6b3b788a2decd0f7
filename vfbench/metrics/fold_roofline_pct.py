"""Kernels (kernels/composite.py, csrc/composite.cu: K4, the compositor's
fold): the least time K4's work on a frame could take, its bytes
(`fold_bytes`) at the card's peak memory bandwidth, over K4's device time a
frame in the traced window (the device operations whose name holds
``composite_fold``), in %; nothing where the card is not in the table of
peaks, K4 did not run, or the cell's configuration has no pads.

The harness hands a reader no configuration, so the reader takes the cell
that this process runs from its command line (``vfbench.run --workload``)."""

from __future__ import annotations

import argparse
import sys

from vfbench import spec

KERNEL = "composite_fold"
RGB = ("BGRA", "RGBA")


def _area(x: int, y: int, w: int, h: int, W: int, H: int) -> int:
    """Pixels of a w x h rect placed at (x, y), clipped to a W x H canvas."""
    return max(0, min(x + w, W) - max(x, 0)) * max(0, min(y + h, H) - max(y, 0))


def fold_bytes(ref: dict) -> int:
    """Bytes K4 moves for one frame of a ``compositor`` reference
    description, as the kernel reads and writes them (kernels/composite.py
    module doc): each pad's rect, clipped to the canvas, read once, as
    uint8 RGBA where an RGB source is drawn at its own size and as float32
    RGBA where a YUV source went through the emit; the folded overlay's
    rect as float32 RGBA; the canvas written once as uint8 RGBA.  The draw
    table (a few hundred bytes) is left out."""
    out = ref["output"]
    W, H = out["width"], out["height"]
    n = W * H * 4
    for pad in ref["pads"]:
        src = ref["sources"][pad["source"]]
        texel = 4 if src["format"] in RGB else 16
        n += texel * _area(pad["xpos"], pad["ypos"], src["width"],
                           src["height"], W, H)
    ov = ref.get("overlay")
    if ov:
        n += 16 * _area(ov["x"], ov["y"], ov["width"], ov["height"], W, H)
    return n


def running_reference():
    """The reference description of the cell named by this process's
    ``--workload``, or None."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    name = ap.parse_known_args(sys.argv[1:])[0].workload
    if name is None:
        return None
    try:
        return spec.load_cell(spec.HERE.parent, name).config["reference"]
    except (KeyError, OSError):
        return None


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.frames or not ctx.peak_bytes_s:
        return None
    device_s = sum(s for name, s in t["device_ops"] if KERNEL in name)
    ref = running_reference()
    if device_s <= 0 or ref is None or not ref.get("pads"):
        return None
    least_s = fold_bytes(ref) / ctx.peak_bytes_s
    return least_s / (device_s / ctx.frames) * 100.0
