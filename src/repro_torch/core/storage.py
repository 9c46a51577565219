"""Storage tier: np.memmap-backed array store with page-granular accounting.

The paper's NVMe tier. Activations/gradients are stored one file per
(layer, kind); partition-contiguous vertex ordering (graph/reorder.py) makes
every partition access a single sequential ranged read/write — the paper's
core I/O discipline (partition-granular access instead of per-vertex random
reads that suffer 16 KiB-page read amplification, §4 / Appendix F).

Counters record both logical bytes and page-rounded physical bytes so the
read-amplification claims can be validated numerically.

Thread-safety: the pipeline runtime (repro_torch/runtime/) issues reads from
prefetch workers and writes from the write-behind thread concurrently with
the main loop. Ranged memmap accesses to disjoint regions are safe; the
lock here guards the array/metadata dicts and the counter updates.
``StorageIOQueue`` is the asynchronous front end: a dedicated I/O thread
services a FIFO of read/write requests with byte-based write backpressure.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import logging
import os
import shutil
import threading
import time
import zlib
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.counters import Counters
from repro_torch.core.threads import join_bounded, spawn

# --------------------------------------------------------------------------
# Lock-holding guard (lint rule R2's runtime mirror): when enabled, blocking
# StorageIOQueue submissions raise if the calling thread currently owns a
# registered consumer lock (e.g. the HostCache RLock that wired itself via
# set_spill_queue). Off by default — it costs an _is_owned() probe per
# submit — and switched on for the whole test suite by tests/conftest.py.
_IO_GUARD = os.environ.get("REPRO_IO_GUARD", "0").lower() not in (
    "0", "", "false", "no",
)


def set_io_guard(enabled: bool) -> None:
    """Enable/disable the blocking-submit-under-lock guard process-wide."""
    global _IO_GUARD
    _IO_GUARD = bool(enabled)


def io_guard_enabled() -> bool:
    return _IO_GUARD

PAGE_BYTES = 16 * 1024  # NVMe page granularity used throughout the paper

_log = logging.getLogger("repro_torch.storage")


# -- exception taxonomy ------------------------------------------------------
class StorageError(IOError):
    """Base for every typed storage failure. Anything that is *not* a
    :class:`TransientIOError` is fatal: it propagates out of the retry
    layer, poisons the pipeline queues, and unwinds ``run_stream``."""


class TransientIOError(StorageError):
    """A fault expected to succeed on retry (EIO blip, torn write that can
    be re-issued, device timeout). The retry layer absorbs these with
    bounded exponential backoff."""


class StorageCorruptionError(StorageError):
    """Checksum mismatch between a read row and its CRC32 sidecar — a torn
    write that was never retried, or bit rot. The retry layer re-reads
    once (transient bus/DMA corruption recovers); a second mismatch means
    the data at rest is bad and the error is fatal."""


class StorageDeadlineError(StorageError):
    """Retry budget or per-op deadline exhausted while a fault stayed
    transient. Fatal: the lane is effectively down."""


class StorageFullError(StorageError):
    """ENOSPC — no retry can help; fatal immediately."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded-exponential-backoff schedule for transient storage faults.

    An op is attempted up to ``1 + max_retries`` times and must finish
    within ``op_deadline_s`` wall-clock (attempts + backoff sleeps);
    exceeding either raises :class:`StorageDeadlineError` chained to the
    last transient error. Corruption is handled separately: up to
    ``corruption_rereads`` re-reads before the mismatch becomes fatal."""

    max_retries: int = 8
    backoff_s: float = 0.002
    backoff_mult: float = 2.0
    backoff_max_s: float = 0.25
    op_deadline_s: float = 10.0
    corruption_rereads: int = 1


class StorageTier:
    def __init__(
        self,
        root: str,
        counters: Optional[Counters] = None,
        page_bytes: int = PAGE_BYTES,
        verify_reads: bool = False,
        retry: Optional[RetryPolicy] = None,
    ):
        self.root = root
        self.page = page_bytes
        self.counters = counters or Counters()
        self.verify_reads = bool(verify_reads)
        self.retry = retry
        self._arrays: Dict[str, np.memmap] = {}
        self._meta: Dict[str, Tuple[tuple, np.dtype]] = {}
        # CRC32 sidecars (verify_reads only): per-row checksum + a validity
        # mask of rows that have been written through write_rows. The CRC is
        # recorded BEFORE the memmap assignment, so a torn write leaves a
        # fresh CRC over stale/partial data — exactly what read verification
        # must catch.
        self._crc: Dict[str, np.ndarray] = {}
        self._crc_ok: Dict[str, np.ndarray] = {}
        self._alloc_bytes = 0
        self._lock = threading.Lock()
        m = self.counters.metrics
        self._m_retries = m.counter("io.retries")
        self._m_deadline = m.counter("io.deadline_misses")
        self._m_rereads = m.counter("io.corruption_rereads")
        os.makedirs(root, exist_ok=True)

    # -- lifecycle ----------------------------------------------------------
    def _path(self, name: str) -> str:
        return os.path.join(self.root, name.replace("/", "_") + ".bin")

    def alloc(self, name: str, shape: tuple, dtype=np.float32) -> None:
        dtype = np.dtype(dtype)
        mm = np.memmap(self._path(name), dtype=dtype, mode="w+", shape=shape)
        with self._lock:
            old = self._meta.get(name)
            if old is not None:  # re-alloc without free: replace accounting
                self._alloc_bytes -= int(np.prod(old[0])) * old[1].itemsize
            self._arrays[name] = mm
            self._meta[name] = (shape, dtype)
            if self.verify_reads:
                n_rows = int(shape[0]) if len(shape) else 0
                self._crc[name] = np.zeros(n_rows, dtype=np.uint32)
                self._crc_ok[name] = np.zeros(n_rows, dtype=bool)
            self._alloc_bytes += int(np.prod(shape)) * dtype.itemsize
            self.counters.sample_storage_alloc(self._alloc_bytes)

    def exists(self, name: str) -> bool:
        return name in self._arrays

    def free(self, name: str) -> None:
        with self._lock:
            if name not in self._arrays:
                return
            mm = self._arrays.pop(name)
            del mm
            shape, dtype = self._meta.pop(name)
            self._crc.pop(name, None)
            self._crc_ok.pop(name, None)
            self._alloc_bytes -= int(np.prod(shape)) * dtype.itemsize
        try:
            os.remove(self._path(name))
        except OSError:
            pass

    def evict(self, name: str) -> None:
        """Write ``name``'s dirty pages to the device (``fsync``) and drop
        them from the OS page cache (``POSIX_FADV_DONTNEED``), so the next
        read comes from the device. The file's mapping is closed first (the
        kernel keeps mapped pages) and reopened after. Call it with no I/O
        on ``name`` in flight. The advice may not take (a file system in
        memory, pages another process maps): read the result's rate."""
        with self._lock:
            mm = self._arrays.pop(name)
            mm.flush()
            del mm
            shape, dtype = self._meta[name]
            fd = os.open(self._path(name), os.O_RDONLY)
            try:
                os.fsync(fd)
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            finally:
                os.close(fd)
            self._arrays[name] = np.memmap(self._path(name), dtype=dtype,
                                           mode="r+", shape=shape)

    def shape(self, name: str) -> tuple:
        return self._meta[name][0]

    def dtype(self, name: str) -> np.dtype:
        return self._meta[name][1]

    @property
    def allocated_bytes(self) -> int:
        """Bytes currently allocated across all files — inference's
        per-layer truncation shows up as a lower peak of this (tracked in
        ``Counters.storage_peak_alloc_bytes``) than the training forward."""
        return self._alloc_bytes

    def close(self) -> None:
        with self._lock:
            self._arrays.clear()
            self._meta.clear()
            self._crc.clear()
            self._crc_ok.clear()
            self._alloc_bytes = 0
        shutil.rmtree(self.root, ignore_errors=True)

    # -- I/O ----------------------------------------------------------------
    def _paged(self, nbytes: int) -> int:
        return ((nbytes + self.page - 1) // self.page) * self.page

    # -- checksum sidecars --------------------------------------------------
    def _record_crcs(self, name: str, row0: int, arr: np.ndarray) -> None:
        crc = self._crc.get(name)
        if crc is None:
            return
        n = int(arr.shape[0])
        for i in range(n):
            crc[row0 + i] = zlib.crc32(np.ascontiguousarray(arr[i]).tobytes())
        self._crc_ok[name][row0 : row0 + n] = True

    def _verify_rows(self, name: str, rows, arr: np.ndarray) -> None:
        """Check each returned row against its sidecar CRC. ``rows`` is an
        iterable of absolute row indices aligned with ``arr``'s first axis;
        rows never written through ``write_rows`` (mask False) are skipped."""
        crc = self._crc.get(name)
        if crc is None:
            return
        ok = self._crc_ok[name]
        for i, r in enumerate(rows):
            r = int(r)
            if not ok[r]:
                continue
            got = zlib.crc32(np.ascontiguousarray(arr[i]).tobytes())
            if got != int(crc[r]):
                raise StorageCorruptionError(
                    f"CRC mismatch in {name!r} row {r}: "
                    f"read {got:#010x}, expected {int(crc[r]):#010x} "
                    "(torn write or bit flip)"
                )

    # -- retry layer --------------------------------------------------------
    def _reliable(self, kind: str, fn, verify=None):
        """Run one storage op with the tier's :class:`RetryPolicy`.

        - :class:`TransientIOError` → bounded exponential backoff, up to
          ``max_retries`` attempts within ``op_deadline_s``; exhaustion
          raises :class:`StorageDeadlineError` (and counts a deadline miss).
        - :class:`StorageCorruptionError` (from ``verify``) → re-read up to
          ``corruption_rereads`` times, then fatal.
        - anything else propagates immediately (fatal).

        This sits at the *tier* so every caller is covered — gather workers
        and the serving path call the tier directly, bypassing the
        :class:`StorageIOQueue`."""
        pol = self.retry
        tracer = self.counters.tracer
        t0 = time.perf_counter()
        attempts = 0
        rereads = 0
        backoff = pol.backoff_s if pol is not None else 0.0
        while True:
            try:
                out = fn()
                if verify is not None:
                    verify(out)
                return out
            except TransientIOError as e:
                if pol is None:
                    raise
                attempts += 1
                elapsed = time.perf_counter() - t0
                if attempts > pol.max_retries or (
                    pol.op_deadline_s is not None
                    and elapsed + backoff > pol.op_deadline_s
                ):
                    self._m_deadline.inc()
                    if tracer.enabled:
                        tracer.instant(f"fault:deadline:{kind}",
                                       args={"attempts": attempts,
                                             "elapsed_s": round(elapsed, 4)})
                    raise StorageDeadlineError(
                        f"{kind} gave up after {attempts} attempts / "
                        f"{elapsed:.3f}s: {e}"
                    ) from e
                self._m_retries.inc()
                if tracer.enabled:
                    with tracer.span(f"retry:{kind}",
                                     args={"attempt": attempts}):
                        time.sleep(backoff)
                else:
                    time.sleep(backoff)
                backoff = min(backoff * pol.backoff_mult, pol.backoff_max_s)
            except StorageCorruptionError:
                max_rr = (pol.corruption_rereads if pol is not None else 1)
                rereads += 1
                if rereads > max_rr:
                    raise
                self._m_rereads.inc()
                if tracer.enabled:
                    tracer.instant(f"fault:corruption_reread:{kind}",
                                   args={"reread": rereads})

    # -- raw single-attempt ops (subclass injection points) -----------------
    def _write_rows_once(self, name: str, row0: int, arr: np.ndarray) -> None:
        # CRC first (see __init__): a tear between the two steps is
        # detectable because the sidecar no longer matches the bytes at rest.
        self._record_crcs(name, row0, arr)
        mm = self._arrays[name]
        mm[row0 : row0 + arr.shape[0]] = arr

    def _read_rows_once(self, name: str, row0: int, row1: int) -> np.ndarray:
        mm = self._arrays[name]
        return np.array(mm[row0:row1])  # copy out of the mapping

    def _read_rows_batched_once(self, requests) -> list:
        outs = []
        for name, row0, row1 in requests:
            mm = self._arrays[name]
            outs.append(np.array(mm[row0:row1]))
        return outs

    def _read_rows_scattered_once(self, name: str,
                                  rows: np.ndarray) -> np.ndarray:
        mm = self._arrays[name]
        return np.array(mm[rows])

    # -- public (reliable, accounted) ops -----------------------------------
    def write_rows(self, name: str, row0: int, arr: np.ndarray) -> None:
        self._reliable("write",
                       lambda: self._write_rows_once(name, row0, arr))
        nb = arr.nbytes
        # one locked trip on the Counters' OWN lock: two tiers sharing one
        # instance (activation + grad files) must not interleave updates
        self.counters.bump_many(
            storage_write_bytes=nb,
            storage_write_paged_bytes=self._paged(nb),
            storage_write_ops=1,
        )

    def read_rows(self, name: str, row0: int, row1: int) -> np.ndarray:
        verify = None
        if self.verify_reads:
            verify = lambda a: self._verify_rows(name, range(row0, row1), a)
        out = self._reliable(
            "read", lambda: self._read_rows_once(name, row0, row1), verify
        )
        nb = out.nbytes
        self.counters.bump_many(
            storage_read_bytes=nb,
            storage_read_paged_bytes=self._paged(nb),
            storage_read_ops=1,
        )
        return out

    def read_rows_batched(self, requests) -> list:
        """Vectored read: service many ``(name, row0, row1)`` ranges in ONE
        submission (io_uring-style), returning one array per range.

        Counted as a single read op — the per-op latency is paid once for
        the whole batch — while logical and page-rounded bytes accumulate
        per range (the ranges are discontiguous, so each one is rounded to
        page granularity separately). This is what the pipeline's prefetch
        stage issues per work unit instead of one ``read_rows`` per source
        partition. A transient fault re-issues the whole batch.
        """
        requests = list(requests)
        if not requests:
            return []
        verify = None
        if self.verify_reads:
            def verify(outs):
                for (name, row0, row1), out in zip(requests, outs):
                    self._verify_rows(name, range(row0, row1), out)
        outs = self._reliable(
            "read_batch", lambda: self._read_rows_batched_once(requests),
            verify,
        )
        nb = paged = 0
        for out in outs:
            nb += out.nbytes
            paged += self._paged(out.nbytes)
        self.counters.bump_many(
            storage_read_bytes=nb,
            storage_read_paged_bytes=paged,
            storage_read_ops=1,
        )
        return outs

    def read_rows_scattered(self, name: str, rows: np.ndarray) -> np.ndarray:
        """Vertex-granular random read (the *anti-pattern* the paper avoids).

        Physical accounting charges one page per non-contiguous row run,
        modelling read amplification. Used by the vertex-wise cache baseline
        (Appendix F comparison).
        """
        verify = None
        if self.verify_reads:
            verify = lambda a: self._verify_rows(name, rows, a)
        out = self._reliable(
            "read_scattered",
            lambda: self._read_rows_scattered_once(name, rows), verify,
        )
        if len(rows) == 0:
            # nothing was touched on the device: no ops, no paged bytes
            return out
        # contiguous runs
        runs = 1 + int(np.sum(np.diff(np.sort(rows)) > 1))
        self.counters.bump_many(
            storage_read_bytes=out.nbytes,
            storage_read_paged_bytes=max(
                runs * self.page, self._paged(out.nbytes)
            ),
            storage_read_ops=runs,
        )
        return out


class StorageIOQueue:
    """Thread-safe asynchronous front end over a :class:`StorageTier`.

    A single dedicated I/O thread services a FIFO of read/write requests,
    each returning a future. Writers are backpressured: ``submit_write``
    blocks while the queued-but-unwritten bytes would exceed
    ``max_inflight_bytes`` (a single over-sized write is admitted when the
    queue is empty so it cannot deadlock). Blocked time is charged to the
    ``write_submit`` stall counter — this is the write-behind stage of the
    pipeline runtime.
    """

    _CLOSE = object()

    def __init__(
        self,
        tier: StorageTier,
        max_inflight_bytes: int = 64 << 20,
        counters: Optional[Counters] = None,
        op_deadline_s: Optional[float] = None,
        slow_lane_factor: float = 4.0,
        slow_lane_min_ops: int = 16,
        slow_lane_recovery_ops: int = 32,
    ):
        self.tier = tier
        self.max_inflight = int(max_inflight_bytes)
        self.counters = counters or tier.counters
        # end-to-end (submit → completion) deadline observation; the tier's
        # RetryPolicy enforces per-attempt budgets, this watches total queue
        # wait + service time and counts misses for the obs layer
        self.op_deadline_s = op_deadline_s
        # EWMA slow-lane detection: an op whose service latency exceeds
        # slow_lane_factor × the running EWMA (after a min_ops warmup)
        # flags the lane slow; slow_lane_recovery_ops consecutive
        # non-outlier ops clear it. Consumers (ForwardRunner) respond by
        # forcing prefetched blocks cache-resident so the slow device is
        # not re-read for data the host already holds.
        self.slow_lane = False
        self._slow_factor = float(slow_lane_factor)
        self._slow_min_ops = int(slow_lane_min_ops)
        self._slow_recovery_ops = int(slow_lane_recovery_ops)
        self._lat_ewma = 0.0
        self._lat_n = 0
        self._slow_recover = 0
        self._cond = threading.Condition()
        self._q: deque = deque()
        self._inflight_bytes = 0
        self._inflight_ops = 0
        # id()s of write payloads queued but not yet on storage — the queue
        # holds a reference to each, so an id stays valid while tracked.
        # BufferPool.release consults this via owns() to refuse recycling a
        # buffer whose write-behind hasn't retired.
        self._inflight_write_ids: set = set()
        self.max_inflight_observed = 0
        self._closed = False
        self._exc: Optional[BaseException] = None
        # obs: queue depth polls live state only when snapshotted; per-op
        # service latency (including any emulated device delay in tier
        # subclasses) is observed in _run around the tier call
        m = self.counters.metrics
        m.gauge("storage.io_queue_depth", fn=lambda: len(self._q))
        m.gauge("storage.io_inflight_bytes", fn=lambda: self._inflight_bytes)
        self._read_lat = m.histogram("storage.read_seconds")
        self._write_lat = m.histogram("storage.write_seconds")
        self._m_deadline = m.counter("io.deadline_misses")
        self._m_slow_flips = m.counter("io.slow_lane_flips")
        # live slow-lane state (not just the flip count): a Prometheus
        # scrape / live sampler tick sees whether the lane is degraded NOW
        m.gauge("io.slow_lane", fn=lambda: 1.0 if self.slow_lane else 0.0)
        # consumer locks registered for the blocking-submit guard (each a
        # re-entrant lock exposing _is_owned, e.g. the HostCache RLock)
        self._guard_locks: list = []
        self._thread = spawn("sso-io", self._run)

    # -- lock-holding guard ---------------------------------------------
    def register_guard_lock(self, lock) -> None:
        """Register a consumer's re-entrant lock: while the guard is on
        (``set_io_guard``/``REPRO_IO_GUARD``), a BLOCKING submission from a
        thread that owns ``lock`` raises instead of risking a stall or a
        deadlock against the cache's own eviction path. The non-blocking
        spill (``submit_write(wait=False)``) stays exempt by design."""
        if lock not in self._guard_locks:
            self._guard_locks.append(lock)

    def unregister_guard_lock(self, lock) -> None:
        try:
            self._guard_locks.remove(lock)
        except ValueError:
            pass

    def _check_guard(self, op: str) -> None:
        if not _IO_GUARD:
            return
        for lk in self._guard_locks:
            owned = getattr(lk, "_is_owned", None)
            if owned is not None and owned():
                raise RuntimeError(
                    f"StorageIOQueue.{op} called from a thread holding a "
                    f"registered cache lock — blocking I/O under the cache "
                    f"lock serializes every cache user behind disk latency "
                    f"(lint rule R2); stage the I/O outside the critical "
                    f"section or use submit_write(wait=False)"
                )

    # -- submission ---------------------------------------------------------
    @property
    def inflight_bytes(self) -> int:
        return self._inflight_bytes

    def owns(self, arr: np.ndarray) -> bool:
        """True while ``arr`` is queued as a write payload that has not yet
        retired to storage (recycling it would corrupt the pending write)."""
        with self._cond:
            return id(arr) in self._inflight_write_ids

    def submit_write(self, name: str, row0: int, arr: np.ndarray,
                     wait: bool = True) -> cf.Future:
        """Queue a ranged write. The caller must not mutate ``arr`` after
        submission (the queue does not copy). ``wait=False`` skips the
        byte backpressure — for callers that must not block while holding
        a lock (the cache's dirty-eviction spill); the bytes still count
        toward the in-flight total that throttles regular writers."""
        if wait:
            self._check_guard("submit_write")
        nb = int(arr.nbytes)
        t0 = time.perf_counter()
        with self._cond:
            if self._closed:
                raise RuntimeError("StorageIOQueue is closed")
            while wait and (
                self._inflight_bytes > 0
                and self._inflight_bytes + nb > self.max_inflight
            ):
                self._cond.wait(0.05)
                if self._exc is not None:
                    raise self._exc
            fut: cf.Future = cf.Future()
            self._q.append(("w", (name, row0, arr), fut,
                            time.perf_counter()))
            self._inflight_bytes += nb
            self._inflight_ops += 1
            self._inflight_write_ids.add(id(arr))
            self.max_inflight_observed = max(
                self.max_inflight_observed, self._inflight_bytes
            )
            self._cond.notify_all()
        stall = time.perf_counter() - t0
        if stall > 0:
            self.counters.record_stall("write_submit", stall)
        return fut

    def submit_read(self, name: str, row0: int, row1: int) -> cf.Future:
        """Queue a ranged read; the future resolves to the array.

        The single FIFO orders reads behind every previously submitted
        write, so a read of a region queued after its write always sees
        the written data — the engine relies on this for grad-file reads
        behind degraded-mode spill writes."""
        self._check_guard("submit_read")
        with self._cond:
            if self._closed:
                raise RuntimeError("StorageIOQueue is closed")
            if self._exc is not None:
                # fail fast: a prior (unawaited) write died — reading around
                # it would silently return stale data
                raise self._exc
            fut: cf.Future = cf.Future()
            self._q.append(("r", (name, row0, row1), fut,
                            time.perf_counter()))
            self._inflight_ops += 1
            self._cond.notify_all()
        return fut

    def submit_read_batch(self, requests) -> cf.Future:
        """Queue one vectored read of many ``(name, row0, row1)`` ranges;
        the future resolves to the list of arrays (one per range). Same
        FIFO ordering guarantee as :meth:`submit_read`."""
        self._check_guard("submit_read_batch")
        with self._cond:
            if self._closed:
                raise RuntimeError("StorageIOQueue is closed")
            if self._exc is not None:
                raise self._exc
            fut: cf.Future = cf.Future()
            self._q.append(("rb", list(requests), fut,
                            time.perf_counter()))
            self._inflight_ops += 1
            self._cond.notify_all()
        return fut

    # -- service thread -----------------------------------------------------
    def _run(self):
        while True:
            with self._cond:
                while not self._q:
                    self._cond.wait(0.05)
                item = self._q.popleft()
            if item is StorageIOQueue._CLOSE:
                return
            kind, payload, fut, t_submit = item
            t0 = time.perf_counter()
            try:
                if kind == "w":
                    self.tier.write_rows(*payload)
                    res = None
                elif kind == "rb":
                    res = self.tier.read_rows_batched(payload)
                else:
                    res = self.tier.read_rows(*payload)
            except BaseException as e:  # surface on drain() and futures
                with self._cond:
                    self._exc = e
                    if kind == "w":
                        self._inflight_bytes -= int(payload[2].nbytes)
                        self._inflight_write_ids.discard(id(payload[2]))
                    self._inflight_ops -= 1
                    self._cond.notify_all()
                fut.set_exception(e)
                continue
            dt = time.perf_counter() - t0
            self._observe_latency(dt)
            if self.op_deadline_s is not None:
                total = time.perf_counter() - t_submit
                if total > self.op_deadline_s:
                    self._m_deadline.inc()
                    if self.counters.tracer.enabled:
                        self.counters.tracer.instant(
                            "fault:deadline_miss",
                            args={"kind": kind, "total_s": round(total, 4)},
                        )
            if kind == "w":
                self._write_lat.observe(dt)
                args = None
                if self.counters.tracer.enabled:
                    args = {"file": payload[0], "bytes": int(payload[2].nbytes)}
                self.counters.record_busy("write_behind", dt, args=args)
            else:
                self._read_lat.observe(dt)
                args = None
                if self.counters.tracer.enabled:
                    if kind == "rb":
                        args = {"ranges": len(payload)}
                    else:
                        args = {"file": payload[0],
                                "rows": int(payload[2] - payload[1])}
                self.counters.record_busy("async_read", dt, args=args)
            with self._cond:
                if kind == "w":
                    self._inflight_bytes -= int(payload[2].nbytes)
                    self._inflight_write_ids.discard(id(payload[2]))
                self._inflight_ops -= 1
                self._cond.notify_all()
            fut.set_result(res)

    def _observe_latency(self, dt: float) -> None:
        """EWMA slow-lane detector (service thread only — no lock needed
        beyond the GIL; ``slow_lane`` is a plain bool read by consumers)."""
        if self._lat_n >= self._slow_min_ops and \
                dt > self._slow_factor * max(self._lat_ewma, 1e-9):
            if not self.slow_lane:
                self.slow_lane = True
                self._m_slow_flips.inc()
                if self.counters.tracer.enabled:
                    self.counters.tracer.instant(
                        "fault:slow_lane",
                        args={"latency_s": round(dt, 5),
                              "ewma_s": round(self._lat_ewma, 5)},
                    )
            self._slow_recover = 0
            # don't fold the outlier into the EWMA — it would mask a
            # second spike right behind the first
            return
        if self.slow_lane:
            self._slow_recover += 1
            if self._slow_recover >= self._slow_recovery_ops:
                self.slow_lane = False
                self._slow_recover = 0
                if self.counters.tracer.enabled:
                    self.counters.tracer.instant("fault:slow_lane_recovered")
        self._lat_n += 1
        if self._lat_n == 1:
            self._lat_ewma = dt
        else:
            self._lat_ewma = 0.9 * self._lat_ewma + 0.1 * dt

    # -- barriers -----------------------------------------------------------
    def drain(self) -> None:
        """Block until every submitted request has been serviced."""
        t0 = time.perf_counter()
        with self._cond:
            while self._q or self._inflight_ops > 0:
                self._cond.wait(0.05)
            if self._exc is not None:
                exc, self._exc = self._exc, None
                raise exc
        stall = time.perf_counter() - t0
        if stall > 0:
            self.counters.record_stall("write_drain", stall)

    def close(self) -> None:
        """Flush all pending writes, then stop the I/O thread.

        A pending fatal I/O error surfaced by the drain re-raises *after*
        the service thread has been told to stop — shutdown always
        completes, and a thread that fails to exit within the join timeout
        is surfaced as a ``threads_leaked`` count plus a warning instead of
        silently leaking."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
        try:
            self.drain()
        finally:
            with self._cond:
                self._q.append(StorageIOQueue._CLOSE)
                self._cond.notify_all()
            join_bounded(self._thread, 5, self.counters,
                         what="storage I/O thread")
