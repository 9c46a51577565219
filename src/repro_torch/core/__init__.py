"""GriNNder core for the port: structured storage offloading
(cache/(re)gather/bypass), the partition plan, the SSO training engine,
the storage fault-injection tier, the micro-batch baseline and the tier
cost model.

Unlike the reference package this ``__init__`` imports no engine eagerly:
the names below load their submodule on first access. The engine imports
the runtime, whose executor imports ``core.cache``, so an eager import here
would be a cycle; importing the storage or cache substrate also stays cheap
and free of any compute framework.
"""
import importlib

_EXPORTS = {
    "Counters": "counters", "PhaseTimer": "counters",
    "HostCache": "cache", "StorageTier": "storage",
    "PartitionPlan": "plan", "WorkUnit": "plan", "build_plan": "plan",
    "SSOEngine": "engine",
    "FaultPolicy": "faults", "FaultyTier": "faults",
    "TierBandwidths": "costmodel", "H100_MACHINE": "costmodel",
    "ModeledTime": "costmodel", "modeled_time": "costmodel",
    "gnn_epoch_flops": "costmodel",
    "microbatch_grads": "microbatch", "build_full_mfg": "microbatch",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
