"""Embedding serving from the storage tier (Ginex-style SSD + host cache).

:class:`EmbeddingServer` answers "give me the embeddings of these nodes
(original graph ids)" against the final-layer table that
:class:`~repro_torch.infer.engine.OffloadedInference` left on storage — the
billion-scale-on-one-machine serving pattern: the table lives on NVMe,
a **dedicated** :class:`~repro_torch.core.cache.HostCache` holds the hot blocks,
and misses are fetched with ONE vectored
:meth:`~repro_torch.core.storage.StorageIOQueue.submit_read_batch` submission per
lookup batch (one storage round trip regardless of how many blocks missed).

Design points:

- **Id mapping.** Queries arrive in ORIGINAL vertex ids; the table is
  stored in the partition-contiguous reordered id space
  (:class:`~repro_torch.graph.reorder.ReorderedGraph` — ``perm`` maps
  reordered→original, its inverse ``inv_perm`` is applied per query).
- **Block-granular caching.** The table is divided into fixed row blocks
  (``block_rows``, default sized to ≈64 KiB) rather than graph partitions:
  serving traffic is random point lookups, and a whole partition per miss
  would be pure read amplification. Cache keys are ``("emb", 0, block)``.
- **Telemetry.** Row-granular hit/miss counts, per-lookup latency
  (p50/p99/mean from the shared exponential-bucket histogram primitive,
  ``serve.lookup_seconds`` in ``counters.metrics``), and total
  queries/rows — the numbers ``benchmarks/serving_throughput.py`` sweeps
  against the cache budget.

Thread-safety: the cache and the I/O queue are thread-safe; concurrent
lookups may race to load the same missing block, in which case the cache
keeps whichever landed first (same discipline as the training gathers).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np

from repro_torch.core.cache import HostCache
from repro_torch.core.counters import Counters
from repro_torch.core.storage import StorageIOQueue, StorageTier
from repro_torch.graph.reorder import ReorderedGraph


class EmbeddingServer:
    def __init__(
        self,
        storage: StorageTier,
        name: str,
        ro: ReorderedGraph,
        cache_budget_bytes: int,
        counters: Optional[Counters] = None,
        block_rows: Optional[int] = None,
        latency_window: int = 8192,
    ):
        self.storage = storage
        self.name = name
        shape = storage.shape(name)
        self.n_rows, self.dim = int(shape[0]), int(shape[1])
        self.table_dtype = storage.dtype(name)
        if ro.perm.shape[0] != self.n_rows:
            raise ValueError(
                f"reorder covers {ro.perm.shape[0]} nodes but table "
                f"'{name}' has {self.n_rows} rows"
            )
        self._inv_perm = ro.inv_perm          # original id -> table row
        row_bytes = self.dim * self.table_dtype.itemsize
        if block_rows is None:
            block_rows = max(1, (64 << 10) // row_bytes)
        self.block_rows = int(block_rows)
        self.counters = counters or Counters()
        self.cache = HostCache(cache_budget_bytes, storage, self.counters)
        self._io = StorageIOQueue(storage, counters=self.counters)
        self._stats_lock = threading.Lock()
        # per-lookup latency: the shared exponential-bucket histogram
        # primitive (replaces a hand-rolled sliding window of raw samples;
        # ``latency_window`` is accepted for API compat but unused)
        del latency_window
        self._lat = self.counters.metrics.histogram("serve.lookup_seconds")
        self.hits = 0          # row-granular: queried row's block resident
        self.misses = 0
        self.queries = 0       # lookup() calls
        self.rows_served = 0
        self._closed = False
        # exporter hooks: the serving stats() numbers double as registry
        # gauges so the Prometheus endpoint / live sampler sees serve-side
        # health (hit rate, volume) next to the storage-lane state, without
        # anyone having to call stats() on a schedule
        m = self.counters.metrics
        m.gauge("serve.queries", fn=lambda: self.queries)
        m.gauge("serve.rows_served", fn=lambda: self.rows_served)
        m.gauge("serve.hits", fn=lambda: self.hits)
        m.gauge("serve.misses", fn=lambda: self.misses)
        m.gauge("serve.hit_rate", fn=self._hit_rate)

    def _hit_rate(self) -> float:
        with self._stats_lock:
            total = self.hits + self.misses
            return (self.hits / total) if total else 0.0

    # ---------------------------------------------------------------- blocks
    def _block_range(self, b: int):
        r0 = b * self.block_rows
        return r0, min(r0 + self.block_rows, self.n_rows)

    def _fetch_blocks(self, blocks):
        """Resolve each block id to its array: cache peek first, then ONE
        vectored read for all misses (inserted into the cache afterwards;
        an over-budget insert degrades to bypass — the rows are still
        served from the freshly read array). Returns
        ``({block: array}, missed_block_ids)``."""
        resident: Dict[int, np.ndarray] = {}
        missing = []
        for b in blocks:
            arr = self.cache.peek(("emb", 0, int(b)))
            if arr is None:
                missing.append(int(b))
            else:
                resident[int(b)] = arr
        if missing:
            # reserve-before-materialize (lint rule R4): claim cache budget
            # for each block BEFORE the vectored read lands the bytes, so
            # peak host memory can't transiently overshoot the budget. A
            # block whose claim fails is served uncached (bypass).
            reqs, reserved = [], {}
            for b in missing:
                r0, r1 = self._block_range(b)
                reqs.append((self.name, r0, r1))
                nb = (r1 - r0) * self.dim * self.table_dtype.itemsize
                reserved[b] = nb if self.cache.reserve(nb) else 0
            try:
                outs = self._io.submit_read_batch(reqs).result()
            except BaseException:
                for nb in reserved.values():
                    if nb:
                        self.cache.unreserve(nb)
                raise
            for b, arr in zip(missing, outs):
                resident[b] = arr
                if reserved[b]:
                    self.cache.put(("emb", 0, b), arr,
                                   reserved_bytes=reserved[b])
                else:
                    self.counters.bump("cache_bypass")
        return resident, set(missing)

    # ---------------------------------------------------------------- lookup
    def lookup(self, node_ids) -> np.ndarray:
        """Embeddings for ``node_ids`` (ORIGINAL graph ids), shape
        ``(len(node_ids), dim)`` in the table's on-storage dtype. Raises on
        out-of-range ids."""
        if self._closed:
            raise RuntimeError("EmbeddingServer is closed")
        t0 = time.perf_counter()
        ids = np.atleast_1d(np.asarray(node_ids, np.int64))
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_rows):
            raise ValueError(
                f"node ids must be in [0, {self.n_rows}); got range "
                f"[{ids.min()}, {ids.max()}]"
            )
        rows = self._inv_perm[ids]
        blocks = rows // self.block_rows
        resident, missed = self._fetch_blocks(np.unique(blocks))
        out = np.empty((ids.size, self.dim), self.table_dtype)
        n_miss_rows = 0
        for b in resident:
            sel = blocks == b
            r0, _ = self._block_range(b)
            out[sel] = resident[b][rows[sel] - r0]
            if b in missed:
                n_miss_rows += int(sel.sum())
        dt = time.perf_counter() - t0
        self._lat.observe(dt)
        with self._stats_lock:
            self.queries += 1
            self.rows_served += int(ids.size)
            self.misses += n_miss_rows
            self.hits += int(ids.size) - n_miss_rows
        tracer = self.counters.tracer
        if tracer.enabled:
            tracer.complete("serve_lookup", dt, args={
                "rows": int(ids.size), "missed_blocks": len(missed),
            })
        return out

    def warm(self, node_ids) -> None:
        """Pre-load the blocks covering ``node_ids`` without serving them
        (deployment warmup); uncounted in the hit/miss telemetry."""
        ids = np.atleast_1d(np.asarray(node_ids, np.int64))
        blocks = np.unique(self._inv_perm[ids] // self.block_rows)
        self._fetch_blocks(blocks)

    # ----------------------------------------------------------------- stats
    def reset_stats(self) -> None:
        """Zero the hit/miss/latency telemetry (cache contents stay warm) —
        call after a warmup phase so :meth:`stats` reports steady state."""
        with self._stats_lock:
            self.hits = self.misses = 0
            self.queries = self.rows_served = 0
        self._lat.reset()

    def stats(self) -> Dict[str, float]:
        with self._stats_lock:
            hits, misses = self.hits, self.misses
            queries, rows = self.queries, self.rows_served
        lat = self._lat.snapshot()
        total = hits + misses
        out = dict(
            queries=queries,
            rows_served=rows,
            hits=hits,
            misses=misses,
            hit_rate=(hits / total) if total else 0.0,
            cache_used_bytes=self.cache.used_bytes,
            cache_budget_bytes=self.cache.budget,
            block_rows=self.block_rows,
            p50_ms=lat["p50"] * 1e3,
            p99_ms=lat["p99"] * 1e3,
            mean_ms=lat["mean"] * 1e3,
        )
        # fault-tolerance visibility: how hard the storage lane is fighting
        # under this serving load (populated when the tier injects/retries;
        # zero on a healthy lane)
        m = self.counters.metrics
        for key, name in (
            ("io_retries", "io.retries"),
            ("io_faults_injected", "io.faults_injected"),
            ("io_deadline_misses", "io.deadline_misses"),
        ):
            inst = m.get(name)
            out[key] = float(inst.value) if inst is not None else 0.0
        return out

    # ------------------------------------------------------------- lifecycle
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._io.close()
