"""Host edge in (core/frame.py HostLayout.upload_into and the compiled
step's upload): host ms a frame of ``edge_seconds["upload"]`` (the host
copy into pinned memory and the enqueued copy to the card), over the
window."""


def read(ctx):
    if not ctx.frames:
        return None
    return ctx.edge["upload"] / ctx.frames * 1e3
