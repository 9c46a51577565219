"""Bounded stage queues with stall accounting for the pipeline runtime.

Each queue sits between two pipeline stages. ``put``/``get`` block when the
queue is full/empty — that blocked time IS the pipeline's stall signal, so
both are timed and charged to the owning :class:`~repro_torch.core.counters.Counters`
under ``<name>.put`` / ``<name>.get`` (the executor maps the main loop's
``get`` onto the ``compute_wait`` stall instead).

An abort event (set when any stage raises, or when the consumer abandons the
stream) wakes every blocked producer/consumer so a failing pipeline tears
down instead of deadlocking on a full queue.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional

from repro_torch.core.counters import Counters

DONE = object()  # end-of-stream sentinel flowing through every stage


class PipelineAbort(Exception):
    """Raised inside a stage blocked on a queue when the pipeline aborts."""


class ReassemblyBuffer:
    """Sequence-numbered in-order join behind N parallel gather workers.

    Workers complete units out of order; ``put(seq, value)`` parks a result
    until the consumer's cursor reaches ``seq``, and blocks once ``capacity``
    results are buffered ahead of the cursor — the backpressure that bounds
    live gather buffers exactly like a bounded queue does for one worker.
    ``get(seq)`` blocks until that sequence number arrives, so the consumer
    always sees the strict schedule order regardless of worker count.

    No deadlock is possible: the worker holding ``seq == cursor`` is never
    blocked in ``put`` (its slot is always admissible), so the cursor always
    advances while producers are alive.
    """

    def __init__(
        self,
        name: str,
        capacity: int,
        counters: Counters,
        abort: threading.Event,
    ):
        self.name = name
        self.counters = counters
        self.abort = abort
        self._cap = max(1, int(capacity))
        self._slots: dict = {}
        self._next = 0
        self._cond = threading.Condition()

    def put(self, seq: int, value, stall_name: Optional[str] = None) -> None:
        t0 = time.perf_counter()
        with self._cond:
            while seq - self._next >= self._cap:
                if self.abort.is_set():
                    raise PipelineAbort(self.name)
                self._cond.wait(0.02)
            if self.abort.is_set():
                raise PipelineAbort(self.name)
            self._slots[seq] = value
            self._cond.notify_all()
        stall = time.perf_counter() - t0
        if stall > 0:
            self.counters.record_stall(stall_name or f"{self.name}.put", stall)

    def get(self, seq: int, stall_name: Optional[str] = None):
        t0 = time.perf_counter()
        with self._cond:
            while seq not in self._slots:
                if self.abort.is_set():
                    raise PipelineAbort(self.name)
                self._cond.wait(0.02)
            value = self._slots.pop(seq)
            self._next = seq + 1
            self._cond.notify_all()
        stall = time.perf_counter() - t0
        if stall > 0:
            self.counters.record_stall(stall_name or f"{self.name}.get", stall)
        return value

    def drain_remaining(self) -> list:
        """Teardown-only: pop every parked value (abort already set, the
        workers joined). The unwind path releases any pooled buffers these
        hold so a faulted epoch leaks nothing."""
        with self._cond:
            vals = list(self._slots.values())
            self._slots.clear()
            self._cond.notify_all()
        return vals


class StageQueue:
    def __init__(
        self,
        name: str,
        capacity: int,
        counters: Counters,
        abort: threading.Event,
    ):
        self.name = name
        self.counters = counters
        self.abort = abort
        self._q: queue.Queue = queue.Queue(maxsize=max(1, capacity))

    def put(self, item, stall_name: Optional[str] = None) -> None:
        t0 = time.perf_counter()
        while True:
            if self.abort.is_set():
                raise PipelineAbort(self.name)
            try:
                self._q.put(item, timeout=0.02)
                break
            except queue.Full:
                continue
        stall = time.perf_counter() - t0
        if stall > 0:
            self.counters.record_stall(stall_name or f"{self.name}.put", stall)

    def get(self, stall_name: Optional[str] = None):
        t0 = time.perf_counter()
        while True:
            try:
                item = self._q.get(timeout=0.02)
                break
            except queue.Empty:
                if self.abort.is_set():
                    raise PipelineAbort(self.name)
                continue
        stall = time.perf_counter() - t0
        if stall > 0:
            self.counters.record_stall(stall_name or f"{self.name}.get", stall)
        return item

    def drain_remaining(self) -> list:
        """Teardown-only: pop everything still queued (sentinels excluded)."""
        items = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return items
            if item is not DONE:
                items.append(item)
