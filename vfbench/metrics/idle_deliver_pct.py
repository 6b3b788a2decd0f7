"""Host edge out (runtime/pipeline.py _readback, _deliver): the share of
the traced window in which the card was idle under the span
``tpuvf_torch.readback``, ``tpuvf_torch.wait`` or ``tpuvf_torch.consume``,
or the harness's sink (``vfbench.sink``, inside consume), innermost span
open (``idle_gaps``), in %; nothing where the program has no such spans."""

NAMES = ("tpuvf_torch.readback", "tpuvf_torch.wait", "tpuvf_torch.consume",
         "vfbench.sink")


def read(ctx):
    t = ctx.trace
    if (t is None or not ctx.frames or t["window_s"] <= 0
            or "enqueue" not in ctx.edge):
        return None
    idle = sum(s for name, s in t["idle_gaps"] if name in NAMES)
    return idle / t["window_s"] * 100.0
