"""Seconds per training epoch of the card's time inside the forward units'
brackets: CUDA events on the compute stream from the unit's inputs landed to
its last kernel (Counters.device_fwd_ns: runtime/accounting.py, traced runs
only). None where no bracket was read."""


def read(ctx):
    if ctx.entry != "train":
        return None
    try:
        ns = ctx.per_step("device_fwd_ns")
    except KeyError:
        return None
    return ns / 1e9 if ns > 0 else None
