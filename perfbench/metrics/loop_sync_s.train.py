"""Seconds per training epoch the compute loop was blocked on the card: a
D2H event's synchronize, a synchronous result copy, the loss scalar
(Counters.loop_sync_ns: runtime/accounting.py, core/engine.py,
runtime/forward.py). None for a program without the field."""


def read(ctx):
    if ctx.entry != "train":
        return None
    try:
        return ctx.per_step("loop_sync_ns") / 1e9
    except KeyError:
        return None
