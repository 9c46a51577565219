"""Seconds per training epoch of the card's time inside the loss and
backward units' brackets: CUDA events on the compute stream from the unit's
inputs landed to its last kernel (Counters.device_loss_ns + device_bwd_ns:
runtime/accounting.py, traced runs only). None where no bracket was
read."""


def read(ctx):
    if ctx.entry != "train":
        return None
    try:
        ns = ctx.per_step("device_loss_ns") + ctx.per_step("device_bwd_ns")
    except KeyError:
        return None
    return ns / 1e9 if ns > 0 else None
