"""Seconds per training epoch the compute loop waited for the pipeline's
stages to hand it a unit (Counters.stage_stall_seconds compute_wait_*:
runtime/executor.py)."""


def read(ctx):
    if ctx.entry != "train":
        return None
    return ctx.stall_per_step("compute_wait")
