"""Seconds per training epoch the compute loop spent in the ∇A write-back,
SSOEngine._grad_accumulate (Counters.loop_scatter_ns: runtime/accounting.py,
core/engine.py). None for a program without the field."""


def read(ctx):
    if ctx.entry != "train":
        return None
    try:
        return ctx.per_step("loop_scatter_ns") / 1e9
    except KeyError:
        return None
