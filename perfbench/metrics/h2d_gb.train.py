"""Bytes copied host to device per training epoch, in GB
(Counters.h2d_bytes: the transfer stage and pinned pool)."""


def read(ctx):
    if ctx.entry != "train":
        return None
    return ctx.per_step("h2d_bytes") / 1e9
