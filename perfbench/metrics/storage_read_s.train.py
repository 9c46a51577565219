"""Seconds per training epoch of storage-tier reads, retries included, on
every thread that reads: gather and prefetch workers, the I/O queue, the
compute loop (Counters.storage_read_ns: core/storage.py). None for a
program without the field."""


def read(ctx):
    if ctx.entry != "train":
        return None
    try:
        return ctx.per_step("storage_read_ns") / 1e9
    except KeyError:
        return None
