"""Frame loops (runtime/pipeline.py _select_buffers): host ms a frame of
``edge_seconds["params.select"]``, the span ``tpuvf_torch.params.select``
(each output frame's buffer picked from every source on the output clock),
over the window; nothing where the program has no such span."""


def read(ctx):
    select = ctx.edge.get("params.select")
    if not ctx.frames or select is None:
        return None
    return select / ctx.frames * 1e3
