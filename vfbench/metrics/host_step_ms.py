"""Frame loops (runtime/pipeline.py run_batched, run_live; params staged
by runtime/staging.py): host ms a frame of the loop's step part
(``PipelineStats.edge_seconds["step"]``: controllers synced, params re-read
and staged, the step enqueued), over the window."""


def read(ctx):
    if not ctx.frames:
        return None
    return ctx.edge["step"] / ctx.frames * 1e3
