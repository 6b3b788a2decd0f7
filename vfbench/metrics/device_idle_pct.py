"""Device (H100): the share of the traced window in which neither a kernel
nor a copy nor a memset ran on the card, in % (torch.profiler)."""


def read(ctx):
    t = ctx.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
