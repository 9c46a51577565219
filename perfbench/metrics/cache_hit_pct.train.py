"""Share of the host cache's lookups that hit over the training window, in
% (Counters.cache_hits / cache_misses: core/cache.py)."""


def read(ctx):
    if ctx.entry != "train":
        return None
    hits = ctx.per_step("cache_hits")
    total = hits + ctx.per_step("cache_misses")
    return 100.0 * hits / total if total > 0 else None
