"""Seconds per training epoch the compute loop spent adding each unit's
side-input cotangent (GCNII's ∇H^0) into grad 1
(Counters.loop_residual_ns: runtime/accounting.py, core/engine.py). None
for a refresh or a program without the field."""


def read(ctx):
    if ctx.entry != "train":
        return None
    try:
        return ctx.per_step("loop_residual_ns") / 1e9
    except KeyError:
        return None
