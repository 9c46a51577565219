"""The scatter_add kernel's (the ∇A write-back's) share of its bandwidth
roofline over a training window, in % (device time from the profiler,
bytes from the plan: perfbench/yardstick.py)."""


def read(ctx):
    if ctx.entry != "train":
        return None
    return ctx.roofline_pct("scatter_add")
