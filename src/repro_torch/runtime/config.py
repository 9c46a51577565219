"""Pipeline runtime configuration (knobs for the async SSO executor)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class PipelineConfig:
    """Knobs for the asynchronous cache-(re)gather-bypass pipeline.

    depth
        Lookahead in work units: how many units ahead of the one currently
        computing may be in the prefetch/gather stages. ``0`` disables the
        pipeline entirely — the engine runs the exact serial schedule the
        equivalence tests pin down. ``1`` is classic double buffering.
    queue_capacity
        Capacity of each bounded stage queue (defaults to ``depth``). Also
        bounds the number of live gather output buffers to
        ``queue_capacity + 1`` per shape bucket.
    write_behind
        Route bypass writes through the storage I/O queue instead of
        blocking the compute loop on them.
    max_inflight_write_bytes
        Write-behind backpressure: ``submit_write`` blocks once this many
        bytes are queued but not yet on storage.
    pin_prefetched
        Pin prefetched partitions in the host cache until their gather
        consumes them, so cache pressure can't evict an in-flight working
        set (pins are counted; over-budget prefetches degrade to bypass).
    gather_workers
        Number of parallel host-gather worker threads. Results are joined
        through a sequence-numbered reassembly buffer, so the compute stage
        still consumes units in strict schedule order (bit-identical math)
        while multi-core boxes shard the gather/aux work.
    aux_fetch
        Run each backward unit's aux fetch (the ∇A^{l+1} read) on the
        gather stage instead of the compute thread, so grad-file reads hide
        behind the previous unit's compute.
    batched_reads
        Prefetch issues ONE vectored storage submission per work unit
        (``StorageTier.read_rows_batched``) covering every missing source
        partition, instead of one ``read_rows`` per partition — paying the
        per-op latency once per unit.
    transfer_stage
        Run host→device staging on a dedicated transfer thread: the next
        unit's gathered (pinned) buffer is copied onto the device with a
        ``non_blocking`` copy on the transfer thread's own CUDA stream while
        the current unit's kernels run, bounded by ``device_slots``. The
        compute stream waits on the copy's event before it reads the staged
        tensors, instead of paying the H2D copy inline.
    device_slots
        Device-side staging slots for the transfer stage. ``2`` is classic
        double buffering (one unit's inputs feeding the kernel, one being
        staged); ``1`` serializes each H2D copy behind the previous unit's
        compute (still correct, no staging ahead).
    async_d2h
        Retire D2H results asynchronously: the compute loop enqueues a
        ``non_blocking`` copy of the device output into a pinned host buffer
        and hands it, with the copy's CUDA event, to a retire thread that
        waits on the event and submits the bypass write — the compute loop
        never blocks on the device→host copy.
    pool_max_bytes
        Cap on bytes parked in the :class:`BufferPool` free lists (pinned
        host memory on a CUDA device). On overflow the stalest shape bucket
        is dropped (counted as ``pool_trims``) so long multi-epoch runs can't
        pin peak gather footprint forever. Size it above one unit's staging
        stack, or every unit pays a fresh pinned allocation.
    kernels
        Hot-loop kernel dispatch (``repro_torch.kernels.dispatch``):
        ``"auto"`` picks the CUDA ``gather_rows`` kernel on a CUDA device and
        the plain PyTorch reference path on the CPU; ``"reference"`` /
        ``"kernel"`` force one side (on a CPU tensor the kernel wrappers run
        their plain versions — how the CPU tests exercise the stacked path).
        Both are bit-identical for the engine's schedules; the kernel path
        additionally skips the host-side gathered copy by staging whole
        partition blocks and indexing rows on device. ``"kernel-fused"``
        also routes the GCN aggregate through the one-kernel
        ``gather_aggregate`` (FMA accumulation, ~1 ulp off the reference).
    trace
        Path to write a Chrome/Perfetto ``trace_event`` JSON timeline of
        the run (open in ``ui.perfetto.dev``). Enables the span tracer on
        the engine's ``Counters``: every pipeline stage's busy intervals,
        per-unit prefetch→compute lifetimes, stalls ≥ 50 µs, cache
        evictions, and the cache-byte counter track are recorded into a
        bounded in-memory ring and exported on ``engine.close()``. ``None``
        (default) keeps the shared no-op tracer — zero hot-path cost.
    trace_ring_events
        Capacity of the trace ring; once full, the oldest events are
        dropped (the export notes how many under ``otherData``).
    thread_join_timeout_s
        How long teardown waits for each pipeline/retire thread before
        declaring it leaked (logged + counted as ``threads_leaked``) and
        unwinding anyway — the bound on ``run_stream``'s "clean raise,
        never a hang" guarantee when a worker is wedged inside a stuck
        storage op.
    slow_lane_pin
        Degradation response to the I/O queue's EWMA slow-lane flag: while
        the storage lane is flagged slow, prefetched partition blocks are
        forced cache-resident (pinned) even when ``pin_prefetched`` is off,
        so the slow device is not re-read for data the host already holds.
        Counted per forced pin as ``slow_lane_pins``.
    """

    depth: int = 0
    queue_capacity: Optional[int] = None
    write_behind: bool = True
    max_inflight_write_bytes: int = 64 << 20
    pin_prefetched: bool = True
    gather_workers: int = 1
    aux_fetch: bool = True
    batched_reads: bool = True
    transfer_stage: bool = True
    device_slots: int = 2
    async_d2h: bool = True
    pool_max_bytes: int = 256 << 20
    kernels: str = "auto"
    trace: Optional[str] = None
    trace_ring_events: int = 1 << 18
    thread_join_timeout_s: float = 5.0
    slow_lane_pin: bool = True

    @property
    def enabled(self) -> bool:
        return self.depth > 0

    @property
    def capacity(self) -> int:
        cap = self.queue_capacity if self.queue_capacity is not None else self.depth
        return max(1, int(cap))
