"""Host edge out (runtime/pipeline.py _readback, _deliver): host ms a
frame of ``edge_seconds`` readback + wait + consume (the readback
enqueued, the wait on the frame's event, the sink's receive), over the
window."""


def read(ctx):
    if not ctx.frames:
        return None
    e = ctx.edge
    return (e["readback"] + e["wait"] + e["consume"]) / ctx.frames * 1e3
