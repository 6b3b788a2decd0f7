"""Host edge in (core/frame.py HostLayout.upload_into): host ms a frame of
``edge_seconds["upload.alloc"]``, the span ``tpuvf_torch.upload.alloc``
(the fresh pinned host buffer's ``torch.empty``), over the window; nothing
where the program has no such span."""


def read(ctx):
    alloc = ctx.edge.get("upload.alloc")
    if not ctx.frames or alloc is None:
        return None
    return alloc / ctx.frames * 1e3
