"""Compiled step (runtime/compiled.py): frames the window ran without a
CUDA graph (``CompiledStep.eager``, counted over the window)."""


def read(ctx):
    return ctx.counters["eager"]
