"""Deterministic storage fault injection for the SSO stack (the port's copy;
numpy only, over the port's storage tier).

On commodity NVMe, transient I/O misbehavior is the common case at scale,
not the exception (Ginex, PAPERS.md). This module provides the *attack
side* of the fault-tolerance layer; detection and recovery live in
:mod:`repro_torch.core.storage` (CRC sidecars +
:class:`~repro_torch.core.storage.RetryPolicy`), the pipeline executor
(clean unwind), and :mod:`repro_torch.train.checkpoint` (atomic saves).

``FaultyTier`` wraps the raw single-attempt ops (``_*_once``), *under* the
tier's retry layer — so an injected :class:`TransientIOError` exercises the
real backoff/re-read machinery end to end, exactly as a flaky device would.

Fault model (all opt-in, rates per op):

- ``error``          transient read/write ``TransientIOError``
- ``torn``           writes only: a partial row range lands on storage,
                     then the op fails transiently. The CRC sidecar was not
                     updated, so an *unretried* tear is detected on read.
- ``corrupt``        reads only: a bit flip in the *returned* buffer
                     (transient bus/DMA corruption) — recovered by the
                     verify-triggered re-read.
- ``media_corrupt``  writes only: a persistent bit flip on storage after a
                     successful write — detected on read, fatal after the
                     one allowed re-read.
- ``latency``        a service-latency spike (sleep) — trips the I/O
                     queue's EWMA slow-lane detector.
- ``stuck``          a longer bounded hang, modelling a wedged op.
- ``enospc``         :class:`StorageFullError` — fatal, never retried.

Determinism: the policy draws a fixed-size uniform vector per op from a
seeded generator under a lock, so the decision *sequence* replays exactly
for a given seed. With multi-threaded direct reads the assignment of
decisions to specific ops depends on thread interleaving; serial runs and
the single-threaded I/O queue replay bit-exactly. Specific op indices can
be targeted with :meth:`FaultPolicy.schedule` (attempt-indexed: a retry of
a faulted op consumes the next index, so a fault scheduled once fires
once).
"""
from __future__ import annotations

import errno
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.counters import Counters
from repro_torch.core.storage import (  # noqa: F401  (re-exported taxonomy)
    RetryPolicy,
    StorageCorruptionError,
    StorageDeadlineError,
    StorageError,
    StorageFullError,
    StorageTier,
    TransientIOError,
)

_READ_FAULTS = ("error", "corrupt", "latency", "stuck", "enospc")
_WRITE_FAULTS = ("error", "torn", "media_corrupt", "latency", "stuck",
                 "enospc")


class FaultPolicy:
    """Seeded, schedulable fault schedule shared by one ``FaultyTier``.

    Rate-based faults draw from a deterministic per-seed stream;
    :meth:`schedule` pins a specific fault to a specific (kind, op-attempt)
    index for precise regression tests. ``max_faults`` bounds the total
    rate-based injections (scheduled ones always fire) so a soak's fault
    count is exact.
    """

    def __init__(
        self,
        seed: int = 0,
        read_error_rate: float = 0.0,
        write_error_rate: float = 0.0,
        torn_write_rate: float = 0.0,
        read_corrupt_rate: float = 0.0,
        latency_spike_rate: float = 0.0,
        latency_spike_s: float = 0.02,
        stuck_op_s: float = 0.25,
        max_faults: Optional[int] = None,
    ):
        self.read_error_rate = float(read_error_rate)
        self.write_error_rate = float(write_error_rate)
        self.torn_write_rate = float(torn_write_rate)
        self.read_corrupt_rate = float(read_corrupt_rate)
        self.latency_spike_rate = float(latency_spike_rate)
        self.latency_spike_s = float(latency_spike_s)
        self.stuck_op_s = float(stuck_op_s)
        self.max_faults = max_faults
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._op: Dict[str, int] = {"read": 0, "write": 0}
        self._sched: Dict[str, Dict[int, List[str]]] = {
            "read": {}, "write": {},
        }
        self.injected: List[tuple] = []  # (kind, op_index, fault)

    def schedule(self, kind: str, op: int, fault: str) -> "FaultPolicy":
        """Pin ``fault`` to the ``op``-th attempt of ``kind`` ∈
        {'read', 'write'}. Returns self for chaining."""
        allowed = _READ_FAULTS if kind == "read" else _WRITE_FAULTS
        if fault not in allowed:
            raise ValueError(f"unknown {kind} fault {fault!r}")
        self._sched[kind].setdefault(op, []).append(fault)
        return self

    @property
    def n_injected(self) -> int:
        with self._lock:
            return len(self.injected)

    def draw(self, kind: str) -> List[str]:
        """Decide the faults for the next ``kind`` op attempt."""
        with self._lock:
            i = self._op[kind]
            self._op[kind] = i + 1
            faults = list(self._sched[kind].get(i, ()))
            # fixed-size draw regardless of configured rates → the stream
            # is a pure function of (seed, attempt index)
            u = self._rng.random(3)
            budget_left = (self.max_faults is None
                           or len(self.injected) < self.max_faults)
            if budget_left:
                if kind == "read":
                    if u[0] < self.read_error_rate:
                        faults.append("error")
                    if u[1] < self.read_corrupt_rate:
                        faults.append("corrupt")
                else:
                    if u[0] < self.write_error_rate:
                        faults.append("error")
                    if u[1] < self.torn_write_rate:
                        faults.append("torn")
                if u[2] < self.latency_spike_rate:
                    faults.append("latency")
            for f in faults:
                self.injected.append((kind, i, f))
            return faults


class FaultyTier(StorageTier):
    """A :class:`StorageTier` whose raw ops misbehave per a
    :class:`FaultPolicy` — detection (``verify_reads``) and recovery
    (``retry``) default ON, since injecting faults without the tolerance
    layer just produces crashes."""

    def __init__(
        self,
        root: str,
        policy: Optional[FaultPolicy] = None,
        counters: Optional[Counters] = None,
        verify_reads: bool = True,
        retry: Optional[RetryPolicy] = RetryPolicy(),
        **kw,
    ):
        super().__init__(root, counters=counters, verify_reads=verify_reads,
                         retry=retry, **kw)
        self.policy = policy
        self._m_faults = self.counters.metrics.counter("io.faults_injected")

    # -- fault application --------------------------------------------------
    def _note(self, kind: str, fault: str) -> None:
        self._m_faults.inc()
        if self.counters.tracer.enabled:
            self.counters.tracer.instant(f"fault:{fault}",
                                         args={"op": kind})

    def _apply_common(self, kind: str, faults: List[str]) -> None:
        """Latency/hang faults first (the op still runs), then the raising
        ones — fatal ENOSPC before transient error, since no retry can
        outlast a full disk."""
        p = self.policy
        if "latency" in faults:
            self._note(kind, "latency")
            time.sleep(p.latency_spike_s)
        if "stuck" in faults:
            self._note(kind, "stuck")
            time.sleep(p.stuck_op_s)
        if "enospc" in faults:
            self._note(kind, "enospc")
            raise StorageFullError(
                errno.ENOSPC, f"injected ENOSPC on {kind}"
            )
        if "error" in faults:
            self._note(kind, "error")
            raise TransientIOError(f"injected transient {kind} error")

    def _flip_bit(self, arr: np.ndarray) -> None:
        flat = arr.view(np.uint8).reshape(-1)
        if flat.size == 0:
            return
        byte = int(self._rng_fault.integers(flat.size))
        flat[byte] ^= np.uint8(1 << int(self._rng_fault.integers(8)))

    @property
    def _rng_fault(self):
        return self.policy._rng

    # -- raw-op overrides ---------------------------------------------------
    def _read_rows_once(self, name, row0, row1):
        faults = self.policy.draw("read") if self.policy else ()
        self._apply_common("read", faults)
        out = super()._read_rows_once(name, row0, row1)
        if "corrupt" in faults:
            self._note("read", "corrupt")
            self._flip_bit(out)
        return out

    def _read_rows_batched_once(self, requests):
        faults = self.policy.draw("read") if self.policy else ()
        self._apply_common("read", faults)
        outs = super()._read_rows_batched_once(requests)
        if "corrupt" in faults and outs:
            self._note("read", "corrupt")
            self._flip_bit(outs[0])
        return outs

    def _read_rows_scattered_once(self, name, rows):
        faults = self.policy.draw("read") if self.policy else ()
        self._apply_common("read", faults)
        out = super()._read_rows_scattered_once(name, rows)
        if "corrupt" in faults:
            self._note("read", "corrupt")
            self._flip_bit(out)
        return out

    def _write_rows_once(self, name, row0, arr):
        faults = self.policy.draw("write") if self.policy else ()
        if "torn" in faults and arr.shape[0] <= 1:
            faults = [f for f in faults if f != "torn"] + ["error"]
        if "torn" in faults:
            self._note("write", "torn")
            # partial rows reach storage, the CRC sidecar does NOT move —
            # a retry rewrites cleanly; an unretried tear is caught by
            # read verification as StorageCorruptionError
            k = max(1, arr.shape[0] // 2)
            mm = self._arrays[name]
            mm[row0 : row0 + k] = arr[:k]
            raise TransientIOError(
                f"injected torn write in {name!r} ({k}/{arr.shape[0]} rows)"
            )
        self._apply_common("write", faults)
        super()._write_rows_once(name, row0, arr)
        if "media_corrupt" in faults and arr.size:
            self._note("write", "media_corrupt")
            mm = self._arrays[name]
            self._flip_bit(np.asarray(mm[row0 : row0 + arr.shape[0]]))
