"""Byte/op telemetry for the SSO engine.

These counters are the measurement substrate for the paper-claim validations:
Table 6/7 (I/O volume & memory footprint), §8.4 (host memory usage), §8.9
(storage write volume), and the tier-bandwidth cost model used to reproduce
Table 1/2/3 speedup ratios on non-GPU hardware.

The pipeline runtime (repro_torch/runtime/) additionally records per-stage busy
time (work done on pipeline worker threads) and per-stage stall time (time a
stage spent blocked on a queue or on write backpressure), from which the
achieved I/O-compute overlap can be derived (paper Fig. 13 bandwidth study).
All mutators are thread-safe: stage workers and the write-behind thread
report into the same instance as the main compute loop.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import defaultdict
from functools import partial
from typing import Dict

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER

# stalls shorter than this are pure queue-poll noise — not worth a trace
# event each (they'd dominate the ring without adding timeline signal)
_TRACE_STALL_MIN_S = 50e-6


@dataclasses.dataclass
class Counters:
    # storage tier (logical + page-granular physical)
    storage_read_bytes: int = 0
    storage_write_bytes: int = 0
    storage_read_paged_bytes: int = 0
    storage_write_paged_bytes: int = 0
    storage_read_ops: int = 0
    storage_write_ops: int = 0
    # peak bytes simultaneously allocated on the storage tier (activation /
    # grad / snapshot files) — inference's per-layer truncation halves this
    storage_peak_alloc_bytes: int = 0
    # host <-> device (the paper's PCIe path)
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    # host-side gather/scatter work
    host_gather_bytes: int = 0
    host_scatter_bytes: int = 0
    # cache behaviour
    cache_hits: int = 0
    cache_misses: int = 0
    cache_evictions: int = 0
    cache_bypass: int = 0
    cache_prefetches: int = 0
    cache_peak_bytes: int = 0
    # runtime buffer pool hygiene (repro_torch/runtime/ BufferPool)
    pool_trims: int = 0            # free-list buckets dropped at the byte cap
    pool_release_rejects: int = 0  # release() calls refused by the guards
    # device compute (flop estimate filled by engine when available)
    device_flops: int = 0
    # fault tolerance (storage retries + runtime unwind paths)
    threads_leaked: int = 0   # pipeline/I-O threads that outlived join timeout
    slow_lane_pins: int = 0   # prefetches forced cache-resident by slow lane

    # soft cap on retained memory-timeline samples: past this the timeline
    # is decimated in place (every 2nd sample dropped, sampling stride
    # doubled) so unbounded soak runs keep a fixed-size, evenly thinned
    # series. cache_peak_bytes stays exact regardless of decimation.
    MEM_TIMELINE_CAP = 65536

    def __post_init__(self):
        self.phase_seconds: Dict[str, float] = defaultdict(float)
        # pipeline runtime accounting (repro_torch/runtime/): stage -> seconds
        self.stage_busy_seconds: Dict[str, float] = defaultdict(float)
        self.stage_stall_seconds: Dict[str, float] = defaultdict(float)
        self._mem_timeline = []  # (t, cache_bytes) samples for Fig-9 style plots
        self._mem_stride = 1     # keep every _mem_stride-th sample
        self._mem_seen = 0       # samples offered since last reset
        self._lock = threading.Lock()
        # observability attachment points (repro_torch/obs/): every component that
        # shares this Counters instance reaches the same tracer + registry.
        # The tracer defaults to the shared disabled singleton; the engine
        # swaps in a live one when PipelineConfig.trace is set.
        self.tracer = NULL_TRACER
        self.metrics = MetricsRegistry()
        # tracer health as registry gauges: the lambdas read self.tracer at
        # poll time, so the engine's live-tracer swap is reflected without
        # re-registration, and a truncated ring is visible in any metrics
        # snapshot / Prometheus scrape — not just in the exported trace
        self.metrics.gauge("trace.dropped_events",
                           fn=lambda: self.tracer.dropped)
        self.metrics.gauge("trace.ring_occupancy",
                           fn=lambda: self.tracer.ring_occupancy)
        # the byte counters as callback gauges (``counters.<field>``), so a
        # live scrape (``obs.live.TelemetryServer``) and the sampler's rings
        # carry the bytes each tier has moved so far
        for f in dataclasses.fields(self):
            if f.name.endswith("_bytes"):
                self.metrics.gauge(f"counters.{f.name}",
                                   fn=partial(getattr, self, f.name))

    def record_phase(self, name: str, seconds: float) -> None:
        with self._lock:
            self.phase_seconds[name] += seconds
        # bridge to the timeline OUTSIDE the counters lock (tracer has its
        # own); span ends "now" because callers report on interval exit
        self.tracer.complete(name, seconds)

    def bump(self, field: str, amount: int = 1) -> None:
        """Thread-safe increment of a scalar counter field. Pipeline gather
        workers (possibly several) share this instance with the main loop,
        and a bare ``+=`` on an attribute is not atomic."""
        with self._lock:
            setattr(self, field, getattr(self, field) + amount)

    def bump_many(self, **fields: int) -> None:
        """Thread-safe increment of several scalar fields in one lock trip
        (``c.bump_many(storage_read_bytes=nb, storage_read_ops=1)``): the
        storage tiers account whole operations this way, so two tiers
        sharing one instance can't interleave half-updated op/byte pairs."""
        with self._lock:
            for field, amount in fields.items():
                setattr(self, field, getattr(self, field) + amount)

    def record_busy(self, stage: str, seconds: float, args=None) -> None:
        """Work executed on a pipeline worker thread (overlappable).

        Every busy interval is also bridged to ``self.tracer`` as a
        completed span named after the stage — which is what guarantees any
        stage with nonzero ``stage_busy_seconds`` shows up on an exported
        timeline. ``args`` (partition id, bytes, file) annotate the span;
        callers guard the dict allocation behind ``tracer.enabled``.
        """
        with self._lock:
            self.stage_busy_seconds[stage] += seconds
        self.tracer.complete(stage, seconds, args=args)

    def record_stall(self, stage: str, seconds: float) -> None:
        """Time a stage spent blocked (queue full/empty, backpressure)."""
        with self._lock:
            self.stage_stall_seconds[stage] += seconds
        if seconds >= _TRACE_STALL_MIN_S:
            self.tracer.complete("stall:" + stage, seconds)

    def sample_memory(self, cache_bytes: int) -> None:
        with self._lock:
            self.cache_peak_bytes = max(self.cache_peak_bytes, cache_bytes)
            self._mem_seen += 1
            if self._mem_seen % self._mem_stride == 0:
                self._mem_timeline.append((time.perf_counter(), cache_bytes))
                if len(self._mem_timeline) >= self.MEM_TIMELINE_CAP:
                    del self._mem_timeline[::2]
                    self._mem_stride *= 2
        if self.tracer.enabled:
            self.tracer.counter("cache_bytes", cache_bytes)

    def sample_storage_alloc(self, alloc_bytes: int) -> None:
        with self._lock:
            self.storage_peak_alloc_bytes = max(
                self.storage_peak_alloc_bytes, alloc_bytes
            )

    @property
    def memory_timeline(self):
        with self._lock:
            return list(self._mem_timeline)

    # stage-name → pass classification for the per-pass overlap split.
    # Forward stages feed the forward loop; backward stages cover the loss
    # logits fetch, regather/snapshot fetch, and the grad aux-fetch. Shared
    # I/O stages (write_behind, async_read) count only toward the blended
    # totals — their work serves both passes. The device-transfer stage
    # records H2D staging busy under "h2d" (transfer thread) and D2H retire
    # busy under "d2h" (retire thread); the compute loop's wait on a staged
    # unit is charged to "compute_wait_xfer_<pass>" and the transfer
    # thread's own wait on the upstream gather to "xfer_wait_up_<pass>".
    FWD_STAGES = ("prefetch", "gather")
    BWD_STAGES = ("prefetch_bwd", "regather", "snap_prefetch", "snap_fetch",
                  "grad_fetch", "loss_fetch")
    # per-pass waits attributable to the storage stages. With the transfer
    # stage on, the compute loop's wait (compute_wait_xfer_*) measures the
    # end of the whole chain INCLUDING the H2D copy itself, so the
    # storage-stage share is the transfer thread's upstream-gather wait
    # (xfer_wait_up_*) — subtracting the chain-end wait would charge H2D
    # time against gather busy and understate per-pass overlap.
    FWD_WAITS = ("compute_wait_fwd", "xfer_wait_up_fwd")
    BWD_WAITS = ("compute_wait_bwd", "compute_wait_loss",
                 "xfer_wait_up_bwd", "xfer_wait_up_loss")
    XFER_STAGES = ("h2d", "d2h")

    def overlap_summary(self, wall_seconds: float) -> Dict[str, float]:
        """Achieved overlap for a run of ``wall_seconds``.

        ``overlapped_seconds`` is worker busy time that did NOT translate
        into the main loop waiting (busy - compute_wait stall): the portion
        of prefetch/gather/write work genuinely hidden behind compute.
        ``overlapped_frac_fwd`` / ``overlapped_frac_bwd`` report the same
        quantity restricted to forward-pass vs backward-pass stages (the
        engine records phase-specific stage and wait names), instead of one
        blended number.

        ``overlapped_frac_xfer`` is the device-transfer (H2D staging + D2H
        retire) busy time hidden behind compute. The compute loop's
        ``compute_wait_xfer_*`` stall measures the end of the whole
        prefetch→gather→transfer chain, so the portion the transfer thread
        itself spent waiting on the upstream gather (``xfer_wait_up_*``) is
        first subtracted — only the remainder is wait attributable to the
        transfer stage.
        """
        with self._lock:
            busy_map = dict(self.stage_busy_seconds)
            stall_map = dict(self.stage_stall_seconds)
        busy = sum(busy_map.values())
        wait = sum(
            v for k, v in stall_map.items() if k.startswith("compute_wait")
        )
        stall_total = sum(stall_map.values())

        def _frac(ov: float) -> float:
            return min(1.0, ov / wall_seconds) if wall_seconds > 0 else 0.0

        overlapped = max(0.0, busy - wait)
        busy_f = sum(busy_map.get(s, 0.0) for s in self.FWD_STAGES)
        ov_f = max(
            0.0, busy_f - sum(stall_map.get(k, 0.0) for k in self.FWD_WAITS)
        )
        busy_b = sum(busy_map.get(s, 0.0) for s in self.BWD_STAGES)
        ov_b = max(
            0.0, busy_b - sum(stall_map.get(k, 0.0) for k in self.BWD_WAITS)
        )
        busy_x = sum(busy_map.get(s, 0.0) for s in self.XFER_STAGES)
        wait_x = sum(
            v for k, v in stall_map.items()
            if k.startswith("compute_wait_xfer")
        )
        up_x = sum(
            v for k, v in stall_map.items() if k.startswith("xfer_wait_up")
        )
        ov_x = max(0.0, busy_x - max(0.0, wait_x - up_x))
        return dict(
            busy_seconds=busy,
            compute_wait_seconds=wait,
            stall_seconds=stall_total,
            overlapped_seconds=overlapped,
            overlapped_frac=_frac(overlapped),
            overlapped_seconds_fwd=ov_f,
            overlapped_frac_fwd=_frac(ov_f),
            overlapped_seconds_bwd=ov_b,
            overlapped_frac_bwd=_frac(ov_b),
            overlapped_seconds_xfer=ov_x,
            overlapped_frac_xfer=_frac(ov_x),
        )

    def snapshot(self) -> Dict[str, float]:
        # taken under the lock: benches snapshot while gather/transfer/IO
        # worker threads are still mutating, and an unlocked read could see
        # a dict mid-resize or torn field/phase combinations
        with self._lock:
            d = {
                f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
            }
            d.update({f"t_{k}": v for k, v in self.phase_seconds.items()})
            d.update(
                {f"busy_{k}": v for k, v in self.stage_busy_seconds.items()}
            )
            d.update(
                {f"stall_{k}": v for k, v in self.stage_stall_seconds.items()}
            )
        return d

    def reset(self) -> None:
        with self._lock:
            for f in dataclasses.fields(self):
                setattr(self, f.name, 0)
            self.phase_seconds.clear()
            self.stage_busy_seconds.clear()
            self.stage_stall_seconds.clear()
            self._mem_timeline.clear()
            self._mem_stride = 1
            self._mem_seen = 0
        # warmup-epoch reset should also restart the trace/metrics so the
        # exported timeline reflects steady state only (own locks; outside)
        self.metrics.reset()
        self.tracer.clear()


class PhaseTimer:
    def __init__(self, counters: Counters, name: str):
        self.counters = counters
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.counters.record_phase(self.name, time.perf_counter() - self.t0)
        return False
