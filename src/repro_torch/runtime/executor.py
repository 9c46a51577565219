"""Asynchronous pipelined I/O runtime for the port's SSO forward (paper Fig. 13).

Turns each per-partition work unit into a multi-stage job

    storage-read / prefetch -> host gather -> device transfer -> device compute
         (worker thread)       (worker threads)  (H2D thread,     (main loop,
                                                   own stream)     current stream)
                                                                      |
                 bypass write-behind (I/O thread) <- D2H retire (retire thread)

flowing through bounded stage queues. The compute stage stays on the caller
thread and consumes gathered buffers strictly in schedule order, so a
pipelined run executes the exact same floating-point program as the serial
one — ``depth=0`` *is* the serial engine, and ``depth>=1`` is bit-identical
to it. What the pipeline changes is only *when* the I/O happens: partition
reads and host gathers for units ``i+1..i+depth`` run while unit ``i``
computes, the next unit's inputs are copied onto the card (a
``non_blocking`` copy from pinned memory on the transfer thread's own CUDA
stream, bounded by :class:`DeviceSlotPool` slots) while the current unit's
kernels run, and bypass writes retire on the storage I/O queue behind the
compute — with ``async_d2h`` the device→host result copy is a
``non_blocking`` copy into pinned memory whose CUDA event the retire thread
waits on, so the compute loop never blocks on either direction of the
host↔device link.

The gather stage may be sharded across ``gather_workers`` threads; their
out-of-order completions are rejoined by a sequence-numbered
:class:`~repro_torch.runtime.queues.ReassemblyBuffer` before the transfer (or
compute) stage sees them.

Gather outputs are recycled through a :class:`BufferPool` of pinned host
buffers (plain host memory on a CPU device) — with ``depth=1`` this is
classic double buffering, and queue capacity bounds live buffers at
``capacity + 1`` per shape bucket. A buffer whose H2D copy is still in
flight is parked with the copy's CUDA event and recycled only once the event
has completed. The pool's free lists are byte-capped (stalest shape bucket
dropped on overflow) so multi-epoch runs don't pin their peak footprint.
"""
from __future__ import annotations

import logging
import resource
import threading
import time
import weakref
from collections import OrderedDict, deque
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.core.cache import HostCache
from repro_torch.core.counters import Counters
from repro_torch.core.storage import StorageIOQueue, StorageTier
from repro_torch.core.threads import join_bounded, spawn
from repro_torch.device import DeviceLike, resolve_device, torch_dtype
from repro_torch.runtime.accounting import DeviceClock, LoopClock
from repro_torch.runtime.config import PipelineConfig
from repro_torch.runtime.queues import (
    DONE, PipelineAbort, ReassemblyBuffer, StageQueue,
)

_log = logging.getLogger("repro_torch.runtime")

# gather stages whose workers account their own CPU time and rusage
_CPU_STAGES = ("gather", "regather")


def _thread_rusage():
    """The calling thread's own resource usage; None where the platform
    has no per-thread usage (``RUSAGE_THREAD`` is Linux's)."""
    who = getattr(resource, "RUSAGE_THREAD", None)
    return resource.getrusage(who) if who is not None else None


class BufferPool:
    """Reusable host-side gather output buffers, keyed by (shape, dtype).

    On a CUDA device every buffer is **pinned** host memory
    (``torch.empty(..., pin_memory=True)``), handed out as a numpy view of
    the pinned tensor, so the transfer stage's ``non_blocking`` H2D copies
    are real asynchronous DMA. The view keeps its tensor's memory alive.

    Recycling is event-gated: ``release(arr, event)`` with the CUDA event of
    the copy that still reads ``arr`` parks the buffer as *pending*; it joins
    the free list only once ``event.query()`` reports the copy complete
    (swept on every :meth:`acquire`). Without an event the buffer is free at
    once.

    Hygiene guards on top of the plain free-list design:

    - ``max_bytes`` caps the total bytes parked on free lists. On overflow
      the least-recently-used shape bucket is dropped wholesale (``trims``
      counts buckets, and ``pool_trims`` on the shared counters), so a long
      multi-epoch run whose layer shapes drift doesn't pin its all-time peak
      footprint forever. Dropped pinned memory returns to PyTorch's caching
      host allocator.
    - ``release`` refuses buffers that are unsafe to recycle: non-ndarray
      objects, non-contiguous arrays, buffers the pool never issued (or
      already took back), and buffers still owned by a pending
      ``StorageIOQueue.submit_write`` (``owner_check``). Rejected releases
      are dropped and counted (``pool_release_rejects``) — the buffer simply
      isn't recycled.
    """

    def __init__(
        self,
        max_bytes: int = 256 << 20,
        counters: Optional[Counters] = None,
        owner_check: Optional[Callable[[np.ndarray], bool]] = None,
        pin: bool = False,
    ):
        self._free: "OrderedDict[tuple, list]" = OrderedDict()
        self._lock = threading.Lock()
        # buffers currently checked out, id() -> weakref. Weakrefs (not bare
        # ids) because a buffer dropped without release — e.g. in-flight on
        # an aborted pipeline — is eventually gc'd and its address reused;
        # the identity check against the live referent keeps such a stale
        # entry from blessing an unrelated array.
        self._issued: dict = {}
        self._issued_sweep_at = 256
        # released buffers whose H2D copy may still be reading them:
        # (event, key, arr), recycled once the event has completed
        self._pending: list = []
        self._free_bytes = 0
        self.max_bytes = int(max_bytes)
        self.counters = counters
        self.owner_check = owner_check
        self.pin = bool(pin)
        self.allocations = 0   # fresh allocations (tests/telemetry)
        self.trims = 0         # free-list buckets dropped at the byte cap
        self.rejected = 0      # release() calls refused by the guards
        if counters is not None:
            m = counters.metrics
            m.gauge("pool.free_bytes", fn=lambda: self._free_bytes)
            m.gauge("pool.allocations", fn=lambda: self.allocations)

    @staticmethod
    def _key(shape: tuple, dtype) -> tuple:
        return (tuple(shape), np.dtype(dtype).str)

    def _alloc(self, shape: tuple, dtype) -> np.ndarray:
        if self.pin:
            t = torch.empty(tuple(shape), dtype=torch_dtype(dtype),
                            pin_memory=True)
            return t.numpy()
        return np.empty(shape, dtype)

    def _mark_issued(self, arr: np.ndarray) -> None:
        # caller holds self._lock
        self._issued[id(arr)] = weakref.ref(arr)
        if len(self._issued) > self._issued_sweep_at:
            dead = [k for k, r in self._issued.items() if r() is None]
            for k in dead:
                del self._issued[k]
            self._issued_sweep_at = max(256, 2 * len(self._issued))

    def _sweep_pending(self) -> None:
        # caller holds self._lock: park every buffer whose copy has landed
        still = []
        for ev, key, arr in self._pending:
            if ev.query():
                self._park(key, arr)
            else:
                still.append((ev, key, arr))
        self._pending = still

    def acquire(self, shape: tuple, dtype) -> np.ndarray:
        key = self._key(shape, dtype)
        with self._lock:
            if self._pending:
                self._sweep_pending()
            lst = self._free.get(key)
            if lst:
                self._free.move_to_end(key)   # bucket is live: keep it young
                arr = lst.pop()
                self._free_bytes -= arr.nbytes
                self._mark_issued(arr)
                return arr
            self.allocations += 1
        arr = self._alloc(shape, dtype)
        with self._lock:
            self._mark_issued(arr)
        return arr

    def _reject(self) -> None:
        # release() is called from compute/transfer/gather threads at once
        with self._lock:
            self.rejected += 1
        if self.counters is not None:
            self.counters.bump("pool_release_rejects")

    def _park(self, key: tuple, arr: np.ndarray) -> None:
        # caller holds self._lock
        self._free.setdefault(key, []).append(arr)
        self._free.move_to_end(key)
        self._free_bytes += arr.nbytes
        while self._free_bytes > self.max_bytes and len(self._free) > 1:
            # drop the stalest bucket (not the one just released into)
            _, lst = self._free.popitem(last=False)
            self._free_bytes -= sum(a.nbytes for a in lst)
            self.trims += 1
            if self.counters is not None:
                self.counters.bump("pool_trims")

    def release(self, arr, event=None) -> None:
        """Return ``arr`` to the pool; with ``event`` (the CUDA event of a
        copy still reading it) it is recycled only after that event."""
        if not isinstance(arr, np.ndarray) or not arr.flags["C_CONTIGUOUS"]:
            self._reject()
            return
        if self.owner_check is not None and self.owner_check(arr):
            self._reject()
            return
        key = (arr.shape, arr.dtype.str)
        with self._lock:
            ref = self._issued.get(id(arr))
            accepted = ref is not None and ref() is arr
            if accepted:
                del self._issued[id(arr)]
                if event is None:
                    self._park(key, arr)
                else:
                    self._pending.append((event, key, arr))
        if not accepted:
            # double release, a buffer this pool never issued, or a stale id
            # from a buffer that was dropped and gc'd
            self._reject()

    @property
    def free_bytes(self) -> int:
        return self._free_bytes

    @property
    def pending(self) -> int:
        """Released buffers still waiting for their copy's event."""
        with self._lock:
            return len(self._pending)

    @property
    def outstanding(self) -> int:
        """Issued buffers still alive and unreleased (dead referents — e.g.
        buffers dropped on an aborted pipeline and since gc'd — don't
        count). Returns to zero after a faulted ``run_stream``."""
        with self._lock:
            return sum(1 for r in self._issued.values() if r() is not None)


class DeviceSlotPool:
    """Counted device-side staging slots for the transfer stage.

    A slot is held from the moment the transfer thread begins staging a
    unit's inputs onto the device until the compute loop finishes consuming
    them — so ``n_slots`` bounds the number of units whose inputs are
    device-resident at once. ``n_slots=2`` is the classic double buffer
    (one unit feeding the kernel, one being staged); ``n_slots=1``
    serializes every H2D copy behind the previous unit's compute. Waits are
    abort-aware and charged to the caller's stall name.
    """

    def __init__(self, n_slots: int, counters: Counters,
                 abort: threading.Event):
        self.n = max(1, int(n_slots))
        self.counters = counters
        self.abort = abort
        self._free = list(range(self.n))
        self._cond = threading.Condition()
        self.peak_in_use = 0

    def acquire(self, stall_name: str = "h2d_wait_slot") -> int:
        t0 = time.perf_counter()
        with self._cond:
            while not self._free:
                if self.abort.is_set():
                    raise PipelineAbort("device_slots")
                self._cond.wait(0.02)
            slot = self._free.pop()
            self.peak_in_use = max(self.peak_in_use, self.n - len(self._free))
        stall = time.perf_counter() - t0
        if stall > 0:
            self.counters.record_stall(stall_name, stall)
        return slot

    def release(self, slot: int) -> None:
        with self._cond:
            self._free.append(slot)
            self._cond.notify_all()


class PipelineExecutor:
    """Drives work units through prefetch/gather/transfer worker stages and
    hands the main loop (item, staged-buffer) tuples in schedule order; owns
    the write-behind storage queue for the bypass stage and the D2H retire
    thread for asynchronous result copies."""

    def __init__(
        self,
        cfg: PipelineConfig,
        counters: Counters,
        storage: StorageTier,
        cache: Optional[HostCache] = None,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.counters = counters
        self.storage = storage
        self.cache = cache
        self._writer: Optional[StorageIOQueue] = None
        if cfg.enabled and cfg.write_behind:
            self._writer = StorageIOQueue(
                storage,
                max_inflight_bytes=cfg.max_inflight_write_bytes,
                counters=counters,
            )
        self.pool = BufferPool(
            max_bytes=cfg.pool_max_bytes,
            counters=counters,
            owner_check=self._writer_owns,
            pin=self.cuda,
        )
        # D2H retire thread (lazy): deferred np.asarray + bypass write
        self._retire_cond = threading.Condition()
        self._retire_q: deque = deque()
        self._retire_inflight = 0
        self._retire_exc: Optional[BaseException] = None
        self._retire_thread: Optional[threading.Thread] = None
        self._closed = False
        # distinguishes per-unit async trace span ids across run_stream
        # calls (seq numbers restart at 0 every layer pass)
        self._stream_seq = 0
        # the calling (compute) thread's states and the card's time per
        # pass: run_stream charges its own share, the engines' loops the rest
        self.loop = LoopClock(counters)
        self.device_clock = DeviceClock(counters, self.device)

    def _writer_owns(self, arr: np.ndarray) -> bool:
        w = self._writer
        return w is not None and w.owns(arr)

    # ------------------------------------------------------------ bypass I/O
    @property
    def writer(self) -> Optional[StorageIOQueue]:
        return self._writer

    def write_rows(self, name: str, row0: int, arr: np.ndarray) -> None:
        """Bypass write: write-behind when pipelined, synchronous otherwise.
        Pipelined callers must hand over ownership of ``arr`` (no copy)."""
        if self._writer is not None:
            self._writer.submit_write(name, row0, arr)
        else:
            self.storage.write_rows(name, row0, arr)

    # ------------------------------------------------------------ D2H retire
    def _start_d2h(self, dev: torch.Tensor):
        """Enqueue the D2H copy of ``dev`` on the calling thread's current
        stream into a fresh pinned buffer (PyTorch's caching host allocator
        recycles those); returns ``(host ndarray, event)``. On a CPU device
        the tensor's own memory is the host copy and there is no event."""
        if not dev.is_cuda:
            return dev.numpy(), None
        host = torch.empty(tuple(dev.shape), dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev.device))
        return host.numpy(), ev

    def retire_write(self, name: str, row0: int, dev: torch.Tensor) -> None:
        """Retire a device-resident result to storage: the compute loop only
        enqueues a ``non_blocking`` D2H copy into a pinned buffer plus an
        event; the retire thread waits on the event and runs the bypass
        write, so the compute loop never blocks on the D2H copy. Counted as
        ``d2h`` stage busy + ``d2h_bytes``. Copies synchronously and writes
        inline when ``async_d2h`` is off or the pipeline is disabled."""
        if not (self.cfg.enabled and self.cfg.async_d2h):
            arr = dev.cpu().numpy()
            self.counters.bump("d2h_bytes", arr.nbytes)
            self.write_rows(name, row0, arr)
            return
        host, ev = self._start_d2h(dev)
        # backpressure: each pending retire holds a pinned result alive, so
        # bound them like staging slots rather than queueing without limit
        cap = max(2, 2 * int(self.cfg.device_slots))
        t0 = time.perf_counter()
        with self._retire_cond:
            if self._closed:
                raise RuntimeError("PipelineExecutor is closed")
            if self._retire_exc is not None:
                raise self._retire_exc
            if self._retire_thread is None:
                self._retire_thread = spawn("sso-d2h", self._retire_worker)
            while self._retire_inflight >= cap:
                self._retire_cond.wait(0.02)
                if self._retire_exc is not None:
                    raise self._retire_exc
            self._retire_q.append((name, row0, host, ev))
            self._retire_inflight += 1
            self._retire_cond.notify_all()
        stall = time.perf_counter() - t0
        if stall > 0:
            self.counters.record_stall("d2h_submit", stall)

    def _retire_worker(self) -> None:
        while True:
            with self._retire_cond:
                while not self._retire_q:
                    if self._closed:
                        return
                    self._retire_cond.wait(0.05)
                name, row0, arr, ev = self._retire_q.popleft()
            t0 = time.perf_counter()
            try:
                if ev is not None:
                    ev.synchronize()   # the D2H copy has landed in `arr`
                self.counters.bump("d2h_bytes", arr.nbytes)
                self.write_rows(name, row0, arr)
            except BaseException as e:  # surfaced on the next drain/retire
                with self._retire_cond:
                    self._retire_exc = e
                    self._retire_inflight -= 1
                    self._retire_cond.notify_all()
                continue
            args = None
            if self.counters.tracer.enabled:
                args = {"file": name, "bytes": int(arr.nbytes)}
            self.counters.record_busy("d2h", time.perf_counter() - t0,
                                      args=args)
            with self._retire_cond:
                self._retire_inflight -= 1
                self._retire_cond.notify_all()

    def _drain_retires(self) -> None:
        with self._retire_cond:
            while self._retire_inflight > 0:
                self._retire_cond.wait(0.05)
            if self._retire_exc is not None:
                exc, self._retire_exc = self._retire_exc, None
                raise exc

    def drain_writes(self) -> None:
        """Barrier: all submitted bypass writes are on storage. Called at
        layer boundaries, before anything reads the freshly written file.
        Retiring D2H copies are drained first — they feed the write queue."""
        self._drain_retires()
        if self._writer is not None:
            self._writer.drain()

    # -------------------------------------------------------------- pipeline
    def run_stream(
        self,
        items: Iterable,
        gather_fn: Callable,
        prefetch_fn: Optional[Callable] = None,
        aux_fn: Optional[Callable] = None,
        transfer_fn: Optional[Callable] = None,
        cleanup_fn: Optional[Callable] = None,
        prefetch_stage: str = "prefetch",
        gather_stage: str = "gather",
        aux_stage: str = "aux_fetch",
        wait_stage: str = "compute_wait",
        xfer_wait_stage: str = "compute_wait_xfer",
        xfer_up_stage: str = "xfer_wait_up",
    ):
        """Yield ``(item, buf, aux)`` in input order, where
        ``buf, aux = gather_fn(item), aux_fn(item)`` — or, when
        ``transfer_fn`` is given, ``transfer_fn(item, buf, aux)``'s
        replacement pair (the engine uses this to swap the host buffers for
        pre-staged device arrays; the transfer fn takes ownership of the
        host buffers).

        Serial (``depth=0``): gather, aux, and transfer run inline on the
        caller thread, in that order — exactly the serial engine's sequence.
        Pipelined: a prefetch worker runs ``prefetch_fn`` up to ``depth``
        units ahead (stage-1 storage reads, cache pinning) and
        ``cfg.gather_workers`` workers assemble buffers and run the aux
        fetch (stage-2); out-of-order completions are joined by a
        sequence-numbered :class:`ReassemblyBuffer` so downstream stages
        still consume strictly in input order. With ``cfg.transfer_stage``
        and a ``transfer_fn``, a dedicated transfer thread consumes the
        joined stream and stages each unit's inputs onto the device while
        the previous unit computes, holding a :class:`DeviceSlotPool` slot
        from staging until the compute loop finishes the unit (``2`` slots =
        device-side double buffer). Caller wait time is charged to the
        ``wait_stage`` stall (``xfer_wait_stage`` when the transfer stage is
        on); worker time to ``prefetch_stage`` / ``gather_stage`` /
        ``aux_stage`` / ``h2d`` busy — phase-specific names let
        :meth:`Counters.overlap_summary` split forward from backward
        overlap and report the transfer stage's own overlapped fraction.

        Failure semantics (runtime/README.md): an exception in any worker
        stage sets the shared abort event — every queue/buffer wait is
        abort-aware, so all stages unwind instead of deadlocking — and the
        first error re-raises here after the workers are joined. Workers
        that outlive ``cfg.thread_join_timeout_s`` (wedged in a stuck I/O
        op) are *counted* (``threads_leaked``) and logged, never silently
        dropped. ``cleanup_fn(item, buf, aux)`` is then invoked for every
        in-flight unit stranded in the reassembly buffer, the transfer
        queue, or a worker's hands (gathered/staged but not yet handed to
        the next queue when the abort hit)
        so pooled buffers and pins are returned even on a faulted epoch.
        """
        items = list(items)
        use_xfer = transfer_fn is not None and self.cfg.transfer_stage
        loop = self.loop
        if not self.cfg.enabled or len(items) <= 1:
            for it in items:
                buf = gather_fn(it)
                aux = aux_fn(it) if aux_fn is not None else None
                if use_xfer:   # same gating as the pipelined path, so the
                    # yielded shape never depends on the item count
                    buf, aux = transfer_fn(it, buf, aux)
                loop.lap("fetch")
                yield it, buf, aux
            return

        c = self.counters
        tracer = c.tracer
        # per-unit async spans (prefetch-start -> compute-consumed) need ids
        # unique across the layer passes of one trace; seq restarts per call
        self._stream_seq += 1
        sid = self._stream_seq
        nworkers = max(1, int(self.cfg.gather_workers))
        abort = threading.Event()
        q_ready = StageQueue("prefetch_out", self.cfg.capacity, c, abort)
        reasm = ReassemblyBuffer("gather_out", self.cfg.capacity, c, abort)
        errors: List[BaseException] = []

        def _part(it):
            p = getattr(it, "p", None)
            return int(p) if p is not None else None

        def _prefetch_worker():
            try:
                for seq, it in enumerate(items):
                    if tracer.enabled:
                        tracer.begin(f"unit:{gather_stage}",
                                     f"{sid}.{seq}", part=_part(it))
                    if prefetch_fn is not None:
                        t0 = time.perf_counter()
                        prefetch_fn(it)
                        dt = time.perf_counter() - t0
                        args = {"part": _part(it)} if tracer.enabled else None
                        c.record_busy(prefetch_stage, dt, args=args)
                    q_ready.put((seq, it))
                for _ in range(nworkers):
                    q_ready.put(DONE)
            except PipelineAbort:
                pass
            except BaseException as e:
                errors.append(e)
                abort.set()

        def _unit_cleanup(unit):
            """Return a stage's in-hand unit (gathered but not handed to
            the next queue when the abort hit) through ``cleanup_fn``."""
            if unit is None or cleanup_fn is None:
                return
            try:
                cleanup_fn(*unit)
            except Exception:
                _log.exception("cleanup_fn failed during unwind")

        cpu_stage = gather_stage in _CPU_STAGES

        def _account_cpu(cpu_ns: int, ru0) -> None:
            """The gather's CPU time on this worker, and its involuntary
            context switches and major faults where the platform reports a
            thread's own usage (``ru0``: the usage before the gather)."""
            ru1 = _thread_rusage()
            if ru0 is None or ru1 is None:
                c.bump("gather_cpu_ns", cpu_ns)
                return
            c.bump_many(gather_cpu_ns=cpu_ns,
                        gather_nivcsw=ru1.ru_nivcsw - ru0.ru_nivcsw,
                        gather_majflt=ru1.ru_majflt - ru0.ru_majflt)

        def _gather_worker():
            inhand = None
            try:
                while True:
                    x = q_ready.get()
                    if x is DONE:
                        return
                    seq, it = x
                    timed = cpu_stage and tracer.enabled
                    ru0 = _thread_rusage() if timed else None
                    t0 = time.perf_counter()
                    cpu0 = time.thread_time_ns() if timed else 0
                    buf = gather_fn(it)
                    inhand = (it, buf, None)
                    cpu = time.thread_time_ns() - cpu0 if timed else 0
                    dt = time.perf_counter() - t0
                    args = {"part": _part(it)} if tracer.enabled else None
                    c.record_busy(gather_stage, dt, args=args)
                    if timed:
                        _account_cpu(cpu, ru0)
                    aux = None
                    if aux_fn is not None:
                        t0 = time.perf_counter()
                        aux = aux_fn(it)
                        inhand = (it, buf, aux)
                        c.record_busy(aux_stage, time.perf_counter() - t0,
                                      args=args)
                    reasm.put(seq, (it, buf, aux))
                    # ownership handed downstream; drop the stale bindings
                    # too — a retained traceback must not pin a buffer the
                    # pool has since reissued
                    inhand = buf = aux = None
            except PipelineAbort:
                pass
            except BaseException as e:
                errors.append(e)
                abort.set()
            finally:
                _unit_cleanup(inhand)

        threads = [spawn("sso-prefetch", _prefetch_worker, start=False)]
        threads += [
            spawn(f"sso-gather-{i}", _gather_worker, start=False)
            for i in range(nworkers)
        ]

        slots: Optional[DeviceSlotPool] = None
        q_dev: Optional[StageQueue] = None
        if use_xfer:
            slots = DeviceSlotPool(self.cfg.device_slots, c, abort)
            q_dev = StageQueue("xfer_out", slots.n, c, abort)

            def _transfer_worker():
                inhand = None
                try:
                    for seq in range(len(items)):
                        it, buf, aux = reasm.get(seq, stall_name=xfer_up_stage)
                        inhand = (it, buf, aux)
                        slot = slots.acquire()
                        t0 = time.perf_counter()
                        buf, aux = transfer_fn(it, buf, aux)
                        # transfer_fn took ownership of the host buffers;
                        # from here the unit is the staged replacement pair
                        inhand = (it, buf, aux)
                        dt = time.perf_counter() - t0
                        args = {"part": _part(it)} if tracer.enabled else None
                        c.record_busy("h2d", dt, args=args)
                        q_dev.put((it, buf, aux, slot))
                        inhand = buf = aux = None  # handed downstream
                except PipelineAbort:
                    pass
                except BaseException as e:
                    errors.append(e)
                    abort.set()
                finally:
                    _unit_cleanup(inhand)

            threads.append(spawn("sso-h2d", _transfer_worker, start=False))

        for t in threads:
            t.start()
        loop.lap("barrier")
        try:
            for seq in range(len(items)):
                if use_xfer:
                    try:
                        it, buf, aux, slot = q_dev.get(
                            stall_name=xfer_wait_stage
                        )
                    except PipelineAbort:
                        break
                    loop.mark()   # the wait is the xfer_wait_stage stall
                    yield it, buf, aux
                    # the unit's device inputs are consumed: free its slot so
                    # the transfer thread can stage the next-but-one unit
                    slots.release(slot)
                    buf = aux = None  # consumer owns it; drop stale bindings
                else:
                    try:
                        it, buf, aux = reasm.get(seq, stall_name=wait_stage)
                    except PipelineAbort:
                        break
                    loop.mark()   # the wait is the wait_stage stall
                    yield it, buf, aux
                    buf = aux = None
                if tracer.enabled:
                    # unit consumed: close its prefetch->compute span
                    tracer.end(f"unit:{gather_stage}", f"{sid}.{seq}")
        finally:
            abort.set()
            join_bounded(threads, self.cfg.thread_join_timeout_s, c,
                         what="pipeline stage thread")
            if cleanup_fn is not None:
                stranded = list(reasm.drain_remaining())
                if q_dev is not None:
                    for x in q_dev.drain_remaining():
                        it, buf, aux, _slot = x
                        stranded.append((it, buf, aux))
                for it, buf, aux in stranded:
                    try:
                        cleanup_fn(it, buf, aux)
                    except Exception:
                        _log.exception("cleanup_fn failed during unwind")
            if errors:
                raise errors[0]

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Flush pending retires and writes, then stop the worker threads.
        Shutdown always completes — a pending retire error is re-raised
        only after the threads are joined and the writer is closed."""
        if self._closed:
            return
        self._closed = True
        try:
            self._drain_retires()   # worker keeps servicing until q empties
        finally:
            t = self._retire_thread
            if t is not None:
                with self._retire_cond:
                    self._retire_cond.notify_all()
                join_bounded(t, self.cfg.thread_join_timeout_s,
                             self.counters, what="D2H retire thread")
            if self._writer is not None:
                self._writer.close()
