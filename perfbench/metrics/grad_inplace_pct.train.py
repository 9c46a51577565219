"""Share of the ∇A write-back's non-contiguous (unit, source partition)
pairs that the card added in place in a page-locked host grad buffer, over
the training window, in % (Counters.scatter_inplace_pairs and
scatter_copy_pairs, the pairs that took the round trip: kernels/dispatch.py).
None for a refresh, a program without the fields, or a window with no
such pair."""


def read(ctx):
    if ctx.entry != "train":
        return None
    try:
        inplace = ctx.per_step("scatter_inplace_pairs")
        total = inplace + ctx.per_step("scatter_copy_pairs")
    except KeyError:
        return None
    return 100.0 * inplace / total if total > 0 else None
