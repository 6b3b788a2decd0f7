"""Kernels (kernels/*, csrc/*.cu): the least time a frame's work could
take, its bytes (vfbench/roofline.py: each input byte read once, each
output byte written once, from the configuration's shapes) at the card's
peak memory bandwidth, over the kernel busy time a frame in the traced
window (the union of the kernels' intervals; copies, memsets and idle time
are the device metric's), in %."""


def read(ctx):
    t = ctx.trace
    if (t is None or not ctx.frames or not ctx.peak_bytes_s
            or t["kernel_busy_s"] <= 0):
        return None
    least_s = ctx.bytes_per_frame / ctx.peak_bytes_s
    return least_s / (t["kernel_busy_s"] / ctx.frames) * 100.0
