"""Kernels (kernels/resample.py, csrc/resample.cu: K1 and K1b, the scaler):
the least time the scaler's work on a frame could take, its bytes
(`scale_bytes`) at the card's peak memory bandwidth, over the device time a
frame in the traced window of K1's and K1b's kernels (the device operations
whose name holds ``resample_rows`` or ``resample_cols``: the kernels that
``resample_rows_f32`` and ``resample_cols_f32`` launch), in %; nothing
where the card is not in the table of peaks, neither kernel ran, or the
cell's configuration scales nothing.

The bytes are the configuration's alone, whatever implements the scaler,
so a scaler fused into fewer passes reads as a higher share."""

from __future__ import annotations

from vfbench.inputs import frame_bytes
from vfbench.metrics.fold_roofline_pct import running_reference

KERNELS = ("resample_rows", "resample_cols")
RGB = ("BGRA", "RGBA")


def scale_bytes(ref: dict):
    """Bytes the scaler moves for one frame of a reference description with
    one source drawn to another size, or None where the output has the
    source's size: each source plane read once as float32, the form K1 and
    K1b take; each sampled plane (Y, U and V; R, G, B and A) written once
    at the output size as float32.  The pass between rows and columns is
    left out."""
    (src,), out = ref["sources"].values(), ref["output"]
    if (src["width"], src["height"]) == (out["width"], out["height"]):
        return None
    planes = 4 if src["format"] in RGB else 3
    return 4 * (frame_bytes(src["format"], src["width"], src["height"])
                + planes * out["width"] * out["height"])


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.frames or not ctx.peak_bytes_s:
        return None
    device_s = sum(s for name, s in t["device_ops"]
                   if any(k in name for k in KERNELS))
    ref = running_reference()
    if device_s <= 0 or ref is None or len(ref.get("sources", ())) != 1:
        return None
    n = scale_bytes(ref)
    if n is None:
        return None
    return n / ctx.peak_bytes_s / (device_s / ctx.frames) * 100.0
