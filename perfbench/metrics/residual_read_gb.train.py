"""Bytes per training epoch that the side input's staging (GCNII's H^0
rows of each unit's own vertices) read from the storage tier for itself,
the cache misses of blocks no gather of the unit reads, in GB
(Counters.residual_read_bytes: runtime/forward.py). None for a refresh
or a program without the field."""


def read(ctx):
    if ctx.entry != "train":
        return None
    try:
        return ctx.per_step("residual_read_bytes") / 1e9
    except KeyError:
        return None
