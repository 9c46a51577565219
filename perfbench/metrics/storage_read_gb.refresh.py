"""Bytes read from the storage tier per refresh over the window, in GB
(Counters.storage_read_bytes: core/storage.py)."""


def read(ctx):
    if ctx.entry != "refresh":
        return None
    return ctx.per_step("storage_read_bytes") / 1e9
