"""Host seconds per training epoch of the gather (forward) and regather
(backward) stages on the pipeline's workers (Counters.stage_busy_seconds:
runtime/executor.py, runtime/forward.py)."""


def read(ctx):
    if ctx.entry != "train":
        return None
    return ctx.busy_per_step("gather", "regather")
