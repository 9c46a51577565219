"""The gather_rows kernel's share of its bandwidth roofline over a refresh
window, in % (device time from the profiler, bytes from the plan:
perfbench/yardstick.py)."""


def read(ctx):
    if ctx.entry != "refresh":
        return None
    return ctx.roofline_pct("gather_rows")
