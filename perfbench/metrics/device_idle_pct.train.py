"""Share of the traced training window in which no kernel or copy ran on
the card, in % (the union of the profiler's device intervals)."""


def read(ctx):
    if ctx.entry != "train":
        return None
    return ctx.idle_pct()
