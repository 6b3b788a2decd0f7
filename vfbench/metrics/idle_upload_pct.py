"""Host edge in (runtime/pipeline.py _upload_rows, core/frame.py
HostLayout.upload_into): the share of the traced window in which the card
was idle under the span ``tpuvf_torch.upload`` or one of its parts
(``tpuvf_torch.upload.*``), innermost span open (``idle_gaps``), in %;
nothing where the program has no upload part spans."""

PREFIX = "tpuvf_torch.upload"


def read(ctx):
    t = ctx.trace
    if (t is None or not ctx.frames or t["window_s"] <= 0
            or "upload.fill" not in ctx.edge):
        return None
    idle = sum(s for name, s in t["idle_gaps"] if name.startswith(PREFIX))
    return idle / t["window_s"] * 100.0
