"""Partition-wise host-memory cache (paper §4).

Entries are keyed ``(kind, layer, partition)`` and hold one partition's rows
of one layer's activations/gradients. Replacement policy follows the paper's
hierarchy:

  1. with ample budget, whole layers stay resident (maximal intra-layer reuse);
  2. under pressure, evict entire layers in LRU order (layer recency = most
     recent touch of any partition of that layer);
  3. if a single layer exceeds the budget, degrade gracefully to
     partition-granular LRU eviction.

Dirty entries (gradient write-back buffers — the paper's "host memory as a
write-back buffer", §3) are flushed to the storage tier on eviction.

Budget discipline: callers that materialize a block *for* the cache (the
engine's snapshot/grad write-back buffers, the prefetch stage's batched
loads, the gather's miss loads) claim the space FIRST via
:meth:`HostCache.reserve` / ``prefetch_many(..., sizes=...)`` /
``get(..., size_hint=...)`` — evictions run before the allocation and the
claim counts toward the budget, so host memory never transiently exceeds
``budget_bytes`` on any engine path; :attr:`HostCache.peak_bytes` records
the high-water mark the regression tests pin against the budget. (Bare
``get``/``prefetch`` calls without a size keep the legacy
materialize-then-insert order and may overshoot by one block.)

Reclaimers (:meth:`HostCache.add_reclaimer`) hold budget for memory that
holds no data, parked for reuse: the engine's page-locked grad blocks
(``repro_torch.runtime.pinned.PageLockedPool``). Their bytes are
reservations, and :meth:`HostCache._make_room` takes them back before it
evicts any entry, so the entries the cache keeps are the ones it would keep
without them. The reclaimed blocks are freed by the thread that asked for
room, after the lock is released and before the call returns.

Concurrency: the pipeline runtime (repro_torch/runtime/) reads through this cache
from prefetch/gather worker threads while the main loop scatter-accumulates
into dirty entries. Pins are therefore *counted* (an entry may be held by
several in-flight pipeline stages at once), loaders run outside the lock so
storage reads overlap main-loop cache traffic, and ``acquire``/``release``
give the scatter path an atomic peek-and-pin so a concurrent eviction can
never drop an update into a flushed-and-forgotten buffer.

Dirty-eviction flushes route through the write-behind ``StorageIOQueue``
when one is wired in (:meth:`HostCache.set_spill_queue` — the engine wires
its pipeline writer): the flush becomes a queue submit instead of a
synchronous ``write_rows`` under the cache lock, so an eviction no longer
stalls every pipeline worker for the duration of a storage write. Readers
of spillable files must then go through the same queue (its FIFO orders a
read behind the spill write of the same region) — the engine routes grad
and snapshot reads that way. Without a queue the flush stays synchronous
under the lock, which the serial engine's single-threaded ordering relies
on.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.counters import Counters
from repro_torch.core.storage import StorageTier

Key = Tuple[str, int, int]  # (kind, layer, partition)


class _Entry:
    __slots__ = ("arr", "tick", "dirty", "pinned", "spill_name", "spill_row0")

    def __init__(self, arr, tick, dirty=False, pinned=0,
                 spill_name=None, spill_row0=0):
        self.arr = arr
        self.tick = tick
        self.dirty = dirty
        self.pinned = int(pinned)   # pin COUNT (0 = evictable)
        self.spill_name = spill_name  # storage target on dirty eviction
        self.spill_row0 = spill_row0


class HostCache:
    def __init__(
        self,
        budget_bytes: int,
        storage: StorageTier,
        counters: Optional[Counters] = None,
    ):
        self.budget = int(budget_bytes)
        self.storage = storage
        self.counters = counters or storage.counters
        self._entries: Dict[Key, _Entry] = {}
        self._bytes = 0
        self._reserved = 0   # bytes reserved ahead of materialization
        self._peak = 0       # high-water mark of _bytes (incl. reservations)
        self._tick = 0
        self._lock = threading.RLock()
        self._spill_queue = None   # Optional[StorageIOQueue]
        self._reclaimers: list = []
        # blocks reclaimed under the lock, freed by the same thread after it
        self._tls = threading.local()
        # obs: callback gauges poll live state only when snapshotted; the
        # hit/miss/eviction totals live on Counters fields, mirrored here so
        # a metrics dump is self-contained
        c = self.counters
        m = c.metrics
        m.gauge("cache.used_bytes", fn=lambda: self._bytes)
        m.gauge("cache.peak_bytes", fn=lambda: self._peak)
        m.gauge("cache.entries", fn=lambda: len(self._entries))
        m.gauge("cache.hits", fn=lambda: c.cache_hits)
        m.gauge("cache.misses", fn=lambda: c.cache_misses)
        m.gauge("cache.evictions", fn=lambda: c.cache_evictions)

    def set_spill_queue(self, queue) -> None:
        """Route dirty-eviction flushes through an async ``StorageIOQueue``
        (pass ``None`` to restore synchronous flushes). The caller owns the
        queue's lifetime and must drain it before freeing/reading spill
        targets outside the queue's FIFO.

        Wiring also registers this cache's lock with the queue's blocking-
        submit guard (``repro_torch.core.storage.set_io_guard``): when the guard
        is on, a blocking ``submit_*`` from a thread that owns this lock
        raises — the runtime mirror of lint rule R2."""
        prev = self._spill_queue
        if prev is not None and prev is not queue:
            prev.unregister_guard_lock(self._lock)
        self._spill_queue = queue
        if queue is not None:
            queue.register_guard_lock(self._lock)

    @property
    def spill_queue(self):
        """The wired spill queue, or ``None``. A second engine sharing this
        cache must NOT replace an existing queue — spill writes and the
        owner's reads would land on different FIFOs, breaking the
        read-behind-spill ordering."""
        return self._spill_queue

    # -- internals ----------------------------------------------------------
    def _touch(self, e: _Entry) -> None:
        self._tick += 1
        e.tick = self._tick

    def _spill(self, name: str, row0: int, arr: np.ndarray) -> None:
        """Flush a dirty buffer: a non-blocking queue submit when a spill
        queue is wired (eviction under the lock stalls on neither the write
        nor the queue's byte backpressure — this runs while the cache RLock
        is held), a synchronous write otherwise."""
        q = self._spill_queue
        if q is not None:
            q.submit_write(name, row0, arr, wait=False)
        else:
            self.storage.write_rows(name, row0, arr)

    def _evict_entry(self, key: Key) -> None:
        # accounting first: if the spill raises (failed queue, closed tier)
        # the entry is gone either way and _bytes must not stay inflated
        e = self._entries.pop(key)
        self._bytes -= e.arr.nbytes
        self.counters.bump("cache_evictions")
        if self.counters.tracer.enabled:
            self.counters.tracer.instant(
                "cache_evict", kind=key[0], layer=key[1], part=key[2],
                bytes=int(e.arr.nbytes), dirty=bool(e.dirty),
            )
        if e.dirty and e.spill_name is not None:
            self._spill(e.spill_name, e.spill_row0, e.arr)

    def _layer_recency(self) -> Dict[Tuple[str, int], int]:
        rec: Dict[Tuple[str, int], int] = {}
        for (kind, layer, _), e in self._entries.items():
            k = (kind, layer)
            rec[k] = max(rec.get(k, -1), e.tick)
        return rec

    def _make_room(self, need: int) -> bool:
        """Free space for `need` bytes. Returns False if impossible."""
        if need > self.budget:
            return False
        # phase 0: memory parked by reclaimers, which holds no data
        for r in self._reclaimers:
            over = self._bytes + need - self.budget
            if over <= 0:
                break
            blocks = r.reclaim(over)
            nb = sum(b.nbytes for b in blocks)
            self._reserved -= nb
            self._bytes -= nb
            if blocks:
                self._tls.__dict__.setdefault("freed", []).append(
                    (r, blocks))
        # phase 1: evict whole layers, least-recently-used layer first
        while self._bytes + need > self.budget:
            rec = self._layer_recency()
            evictable_layers = [
                kl for kl in sorted(rec, key=rec.get)
                if any(
                    not e.pinned
                    for (k2, l2, _), e in self._entries.items()
                    if (k2, l2) == kl
                )
            ]
            if not evictable_layers:
                return False
            target = evictable_layers[0]
            keys = [
                k for k, e in self._entries.items()
                if (k[0], k[1]) == target and not e.pinned
            ]
            # single-layer-overflow degradation: partition-wise LRU inside
            # the layer instead of dropping it wholesale
            keys.sort(key=lambda k: self._entries[k].tick)
            for k in keys:
                self._evict_entry(k)
                if self._bytes + need <= self.budget:
                    break
        return True

    def _release_reclaimed(self) -> None:
        """Free what this thread's ``_make_room`` reclaimed, outside the
        lock (freeing page-locked memory waits for the card)."""
        freed = self._tls.__dict__.pop("freed", None)
        for r, blocks in freed or ():
            r.release(blocks)

    def add_reclaimer(self, r) -> None:
        """``r.reclaim(nbytes)`` (called under the lock) gives up parked
        blocks of at least ``nbytes`` where it has them, each with an
        ``nbytes`` that it holds reserved here; ``r.release(blocks)`` frees
        them."""
        with self._lock:
            self._reclaimers.append(r)

    def remove_reclaimer(self, r) -> None:
        with self._lock:
            if r in self._reclaimers:
                self._reclaimers.remove(r)

    def _insert(self, key: Key, e: _Entry) -> None:
        self._entries[key] = e
        self._bytes += e.arr.nbytes
        self._peak = max(self._peak, self._bytes)

    # -- reservations --------------------------------------------------------
    def reserve(self, nbytes: int) -> bool:
        """Claim ``nbytes`` of budget BEFORE materializing the block that
        will occupy it: evictions happen now, and the claimed bytes count
        toward the budget so no concurrent insert can overshoot it. Pair
        with ``put(..., reserved_bytes=nbytes)`` to consume the claim, or
        :meth:`unreserve` to abandon it (e.g. the load failed). Returns
        False when the budget cannot cover the claim even after eviction —
        the caller should fall back to its uncached path without loading."""
        nbytes = int(nbytes)
        try:
            with self._lock:
                if not self._make_room(nbytes):
                    return False
                self._claim(nbytes)
                return True
        finally:
            self._release_reclaimed()

    def _claim(self, nbytes: int) -> None:
        # caller holds self._lock
        self._reserved += nbytes
        self._bytes += nbytes
        self._peak = max(self._peak, self._bytes)
        self.counters.sample_memory(self._bytes)

    def reserve_idle(self, nbytes: int, then: Callable[[], None]) -> bool:
        """:meth:`reserve` of budget that is free now, evicting and
        reclaiming nothing; ``then`` runs under the lock once the claim is
        made (a reclaimer parks the block it is for, so that the next
        ``_make_room`` can take it back). Returns False, with nothing
        claimed, when the budget has no such room."""
        nbytes = int(nbytes)
        with self._lock:
            if self._bytes + nbytes > self.budget:
                return False
            self._claim(nbytes)
            then()
            return True

    def unreserve(self, nbytes: int) -> None:
        """Release a claim taken with :meth:`reserve` (caller must pass the
        same byte count)."""
        nbytes = int(nbytes)
        with self._lock:
            self._reserved -= nbytes
            self._bytes -= nbytes

    # -- API ----------------------------------------------------------------
    @property
    def used_bytes(self) -> int:
        """Bytes counted against the budget: resident entries plus
        outstanding reservations."""
        return self._bytes

    @property
    def peak_bytes(self) -> int:
        """High-water mark of :attr:`used_bytes` — with the reserve-first
        protocol this never exceeds ``budget`` (the regression the
        transient-overshoot fix pins down)."""
        return self._peak

    @property
    def total_pins(self) -> int:
        """Sum of pin counts across resident entries. The pipeline unwind
        contract (runtime/README.md, "Failure semantics") requires this to
        return to zero after a faulted epoch — the deadlock regression
        suite asserts it."""
        with self._lock:
            return sum(e.pinned for e in self._entries.values())

    def get(
        self,
        key: Key,
        loader: Callable[[], np.ndarray],
        size_hint: Optional[int] = None,
    ) -> np.ndarray:
        """Fetch a partition block, loading through the cache on miss.

        If the block cannot fit even after eviction, it streams through
        uncached (counted as bypass). The loader runs OUTSIDE the lock, so a
        pipeline worker's storage read never blocks main-loop cache traffic;
        a racing load of the same key keeps whichever copy landed first.

        With ``size_hint`` (the block's nbytes, knowable from the plan
        before the read) the miss path follows the reserve-first protocol:
        budget is claimed — and evictions run — BEFORE the loader
        materializes the block, so host memory never transiently exceeds
        the budget; an unfittable block streams through without an insert
        attempt. Without the hint the legacy materialize-then-insert order
        applies (one block of transient overshoot)."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self.counters.bump("cache_hits")
                self._touch(e)
                return e.arr
            self.counters.bump("cache_misses")
        reserved = size_hint is not None and self.reserve(size_hint)
        try:
            arr = loader()
        except BaseException:
            if reserved:
                self.unreserve(size_hint)
            raise
        with self._lock:
            if reserved:
                self._reserved -= int(size_hint)
                self._bytes -= int(size_hint)
            e = self._entries.get(key)
            if e is not None:  # racing loader won; use the resident copy
                self._touch(e)
                return e.arr
            if (size_hint is None or reserved) and self._make_room(arr.nbytes):
                self._tick += 1
                self._insert(key, _Entry(arr, self._tick))
            else:
                self.counters.bump("cache_bypass")
            self.counters.sample_memory(self._bytes)
        self._release_reclaimed()
        return arr

    def prefetch(
        self,
        key: Key,
        loader: Callable[[], np.ndarray],
        pin: bool = False,
        size_hint: Optional[int] = None,
    ) -> bool:
        """Stage-1 of the pipeline: ensure ``key`` is resident (loading it if
        needed) without returning the data. With ``pin=True`` the entry's pin
        count is raised so it stays resident until the consuming gather calls
        :meth:`unpin`. Returns False when the entry could not be kept
        resident (budget too tight) — the later ``get`` will reload.
        ``size_hint`` engages the reserve-first protocol (see
        :meth:`prefetch_many`'s ``sizes``). Single-key form of
        :meth:`prefetch_many`."""
        sizes = {key: int(size_hint)} if size_hint is not None else None
        return self.prefetch_many(
            [key], lambda _ks: [loader()], pin=pin, sizes=sizes
        )[key]

    def prefetch_many(
        self,
        keys,
        batch_loader: Callable[[list], list],
        pin: bool = False,
        sizes: Optional[Dict[Key, int]] = None,
    ) -> Dict[Key, bool]:
        """Batched stage-1 prefetch: ensure every key is resident, loading
        the missing ones with a single ``batch_loader(missing_keys)`` call
        (the engine backs this with a vectored storage read — one
        submission per work unit instead of one per partition). Pin
        semantics match :meth:`prefetch`. Returns ``{key: resident}``;
        a key is pinned iff it is resident and ``pin`` is set.

        With ``sizes`` (``{key: nbytes}`` for every key), budget is
        **reserved before the load**: evictions run up front, keys that
        cannot fit are reported non-resident (and counted as bypass)
        WITHOUT being read, and host memory never transiently exceeds
        ``budget_bytes`` — the later ``get`` streams the dropped keys
        uncached. Without ``sizes`` the legacy behavior applies: the whole
        missing working set is materialized before insertion, so transient
        host memory can overshoot the budget by up to one unit's missing
        blocks."""
        out: Dict[Key, bool] = {}
        missing = []
        with self._lock:
            for key in keys:
                self.counters.bump("cache_prefetches")
                e = self._entries.get(key)
                if e is not None:
                    self._touch(e)
                    if pin:
                        e.pinned += 1
                    out[key] = True
                else:
                    missing.append(key)
            reserved: Dict[Key, int] = {}
            if sizes is not None:
                admitted = []
                for key in missing:
                    nb = int(sizes[key])
                    if self._make_room(nb):
                        self._reserved += nb
                        self._bytes += nb
                        self._peak = max(self._peak, self._bytes)
                        reserved[key] = nb
                        admitted.append(key)
                    else:
                        # cannot hold it: skip the read entirely — the
                        # consuming get() streams it through uncached
                        self.counters.bump("cache_bypass")
                        out[key] = False
                missing = admitted
                self.counters.sample_memory(self._bytes)
        self._release_reclaimed()
        if not missing:
            return out
        try:
            arrs = batch_loader(missing)
        except BaseException:
            with self._lock:
                for nb in reserved.values():
                    self._reserved -= nb
                    self._bytes -= nb
            raise
        with self._lock:
            for key, arr in zip(missing, arrs):
                nb = reserved.pop(key, 0)
                self._reserved -= nb
                self._bytes -= nb
                e = self._entries.get(key)
                if e is not None:  # racing loader won; keep resident copy
                    self._touch(e)
                    if pin:
                        e.pinned += 1
                    out[key] = True
                    continue
                # with a reservation this always fits (the claim kept the
                # space); without sizes it may evict or fall through
                if self._make_room(arr.nbytes):
                    self._tick += 1
                    self._insert(
                        key, _Entry(arr, self._tick, pinned=1 if pin else 0)
                    )
                    out[key] = True
                else:
                    self.counters.bump("cache_bypass")
                    out[key] = False
            for nb in reserved.values():  # loader returned fewer arrays
                self._reserved -= nb
                self._bytes -= nb
            self.counters.sample_memory(self._bytes)
        self._release_reclaimed()
        return out

    def put(
        self,
        key: Key,
        arr: np.ndarray,
        dirty: bool = False,
        pinned: bool = False,
        spill_name: Optional[str] = None,
        spill_row0: int = 0,
        reserved_bytes: int = 0,
    ) -> bool:
        """Insert (e.g. gradient write-back buffer). Returns False if the
        entry could not be cached (caller must handle, e.g. direct storage).

        ``reserved_bytes`` consumes a prior :meth:`reserve` claim atomically
        with the insert (the reserve-then-materialize protocol: the claim
        held the space, so host memory never exceeded the budget while the
        caller built ``arr``). The claim is released here whether or not
        the insert succeeds.

        Replacing an existing DIRTY entry first flushes it to its spill
        target — silently dropping it would lose unflushed gradient data."""
        with self._lock:
            if reserved_bytes:
                self._reserved -= int(reserved_bytes)
                self._bytes -= int(reserved_bytes)
            old = self._entries.get(key)
            if old is not None:
                if old.dirty and old.spill_name is not None \
                        and old.arr is not arr:
                    self._spill(old.spill_name, old.spill_row0, old.arr)
                self._evict_silent(key)
            fits = self._make_room(arr.nbytes)
            if fits:
                self._tick += 1
                self._insert(key, _Entry(
                    arr, self._tick, dirty=dirty, pinned=1 if pinned else 0,
                    spill_name=spill_name, spill_row0=spill_row0,
                ))
                self.counters.sample_memory(self._bytes)
        self._release_reclaimed()
        return fits

    def _evict_silent(self, key: Key) -> None:
        e = self._entries.pop(key)
        self._bytes -= e.arr.nbytes

    def peek(self, key: Key) -> Optional[np.ndarray]:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            self._touch(e)
            return e.arr

    def acquire(self, key: Key) -> Optional[np.ndarray]:
        """Atomic peek-and-pin: the returned array cannot be evicted until
        the caller invokes :meth:`release`. Used by the scatter-accumulate
        path so pipeline workers can't flush a buffer mid-update."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return None
            self._touch(e)
            e.pinned += 1
            return e.arr

    def release(self, key: Key) -> None:
        self.unpin(key)

    def pin(self, key: Key) -> bool:
        """Raise the pin count of a resident entry. Returns False if absent."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return False
            e.pinned += 1
            return True

    def unpin(self, key: Key) -> None:
        """Drop one pin (no-op when the entry is absent or unpinned)."""
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                e.pinned = max(0, e.pinned - 1)

    def contains(self, key: Key) -> bool:
        return key in self._entries

    def drop(self, key: Key, flush: bool = True) -> None:
        with self._lock:
            if key in self._entries:
                if flush:
                    self._evict_entry(key)
                else:
                    self._evict_silent(key)

    def drop_layer(self, kind: str, layer: int, flush: bool = True) -> None:
        with self._lock:
            keys = [k for k in self._entries if k[0] == kind and k[1] == layer]
            for k in keys:
                self.drop(k, flush=flush)

    def flush_all(self) -> None:
        with self._lock:
            for k in list(self._entries):
                self._evict_entry(k)
