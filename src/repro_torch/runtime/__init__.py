"""Async pipelined I/O runtime for the port (see ``repro_torch.runtime.executor``).

Stages: storage-read/prefetch -> host gather -> H2D transfer (own CUDA
stream) -> device compute -> D2H retire -> bypass write-behind, over bounded
queues with stall/overlap accounting in
:class:`repro_torch.core.counters.Counters`.
"""
from repro_torch.runtime.config import PipelineConfig
from repro_torch.runtime.executor import (
    BufferPool, DeviceSlotPool, PipelineExecutor,
)
from repro_torch.runtime.forward import ForwardRunner
from repro_torch.runtime.queues import (
    DONE, PipelineAbort, ReassemblyBuffer, StageQueue,
)

__all__ = [
    "PipelineConfig", "PipelineExecutor", "BufferPool", "DeviceSlotPool",
    "ForwardRunner", "StageQueue", "ReassemblyBuffer", "PipelineAbort",
    "DONE",
]
