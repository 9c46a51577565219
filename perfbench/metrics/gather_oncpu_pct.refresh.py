"""Share of the gather workers' busy time they ran on a CPU over a refresh,
in % (Counters.gather_cpu_ns, the workers' own thread CPU time, over
stage_busy_seconds of gather: runtime/executor.py, traced runs only). Below
100 the workers waited: descheduled, or blocked in a read or on a lock.
None for a program without the field or with no busy time."""


def read(ctx):
    if ctx.entry != "refresh":
        return None
    busy = ctx.busy_per_step("gather")
    try:
        cpu = ctx.per_step("gather_cpu_ns") / 1e9
    except KeyError:
        return None
    return 100.0 * cpu / busy if busy > 0 and cpu > 0 else None
