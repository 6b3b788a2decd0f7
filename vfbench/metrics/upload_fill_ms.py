"""Host edge in (core/frame.py HostLayout.upload_into): host ms a frame of
``edge_seconds["upload.fill"]``, the span ``tpuvf_torch.upload.fill`` (the
host copy of the frames into the pinned buffer), over the window; nothing
where the program has no such span."""


def read(ctx):
    fill = ctx.edge.get("upload.fill")
    if not ctx.frames or fill is None:
        return None
    return fill / ctx.frames * 1e3
