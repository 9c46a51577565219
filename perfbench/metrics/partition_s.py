"""Host seconds of the set-up's switching_aware_partition and build_plan
(graph/partition.py, core/plan.py), the part of setup_s they take."""


def read(ctx):
    return ctx.timings["partition_s"] + ctx.timings["build_plan_s"]
