"""Model FLOPs of a training epoch (forward and backward, no recompute:
perfbench/yardstick.py) over the traced run's epoch time, as a share of
the card's float32 peak, in %."""


def read(ctx):
    if ctx.entry != "train":
        return None
    return ctx.mfu_pct()
