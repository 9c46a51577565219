"""Model FLOPs of a refresh (one forward: perfbench/yardstick.py) over the
traced run's refresh time, as a share of the card's float32 peak, in %."""


def read(ctx):
    if ctx.entry != "refresh":
        return None
    return ctx.mfu_pct()
