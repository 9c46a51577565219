"""The host gather's copy rate over a refresh window, in GB/s: the bytes
the gathers assembled over the time of their row and block copies alone,
cache lookups and storage reads left out (Counters.host_gather_bytes /
host_copy_ns: runtime/forward.py). None for a program without the field or
with no copy time."""


def read(ctx):
    if ctx.entry != "refresh":
        return None
    try:
        ns = ctx.per_step("host_copy_ns")
    except KeyError:
        return None
    return ctx.per_step("host_gather_bytes") / ns if ns > 0 else None
