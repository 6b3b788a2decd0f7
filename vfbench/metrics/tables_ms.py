"""Compositor (runtime/pipeline.py _frame_tables, the compositors'
``draw_table``): host ms a frame of ``edge_seconds["params.tables"]``, the
span ``tpuvf_torch.params.tables`` (each frame's prepare pass of the
compositors, the draw table packed), over the window; nothing where the
program has no such span."""


def read(ctx):
    tables = ctx.edge.get("params.tables")
    if not ctx.frames or tables is None:
        return None
    return tables / ctx.frames * 1e3
