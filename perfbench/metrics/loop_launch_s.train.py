"""Seconds per training epoch the compute loop spent building and enqueuing
the units' device work: the wait on staged inputs, the layer's forward, vjp
or loss, the D2H enqueue (Counters.loop_launch_ns: runtime/accounting.py,
core/engine.py, runtime/forward.py). None for a program without the
field."""


def read(ctx):
    if ctx.entry != "train":
        return None
    try:
        return ctx.per_step("loop_launch_ns") / 1e9
    except KeyError:
        return None
