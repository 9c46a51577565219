"""Host seconds per refresh of the gather stage on the pipeline's workers
(Counters.stage_busy_seconds: runtime/executor.py, runtime/forward.py)."""


def read(ctx):
    if ctx.entry != "refresh":
        return None
    return ctx.busy_per_step("gather")
