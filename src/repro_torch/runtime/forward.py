"""Composable pipelined forward pass — the cache→gather→transfer→compute→
bypass chain shared by training and inference (PyTorch/CUDA port).

:class:`ForwardRunner` owns the forward half of the SSO workflow that used to
live inside ``SSOEngine.forward``: partition-block loading through the
:class:`~repro_torch.core.cache.HostCache`, the host-side gather (one
sequential run per source partition), the pipeline prefetch stage (vectored
storage reads + counted cache pins), H2D staging on the runtime's transfer
thread (a ``non_blocking`` copy from pinned memory on its own CUDA stream;
the compute stream waits on the copy's event before it reads the staged
tensors), the layer apply on the device, and the bypass write of the output
activations — all streamed through :meth:`PipelineExecutor.run_stream` in
strict schedule order, so a pipelined layer pass stays bit-identical to the
serial one.

Two drivers share it:

- :class:`~repro_torch.core.engine.SSOEngine` (training): runs every layer
  through :meth:`run_layer` and hooks ``after_compute`` in snapshot mode to
  persist ``GA_p^{l-1}``; its backward regathers through :meth:`gather`,
  :meth:`stacked_gather` and :meth:`prefetch_unit`.
- ``OffloadedInference`` (serving): forward-only, so it adds the
  inference-only wins on top — per-layer storage truncation (layer ``l-1``'s
  activation file is freed as soon as layer ``l`` finishes) and optional
  fp16 on-storage activations (``store_dtype``; gathers upcast to the
  compute dtype, bypass writes downcast).

``store_dtype`` controls what lives on storage (and therefore in the host
cache, whose entries are raw storage blocks); compute always happens in
``dtype``. With ``store_dtype == dtype`` the gather uses the GIL-releasing
``np.take`` fast path and the byte flow is exactly the training engine's.

A module that reads a side input (``GNNSpec.side_input``: GCNII's
convolutions read ``H^0``) gets the rows of that layer for the unit's own
vertices staged beside its gather, on the same worker and through the same
cache: :meth:`ForwardRunner.side_rows`, prefetched with the unit's blocks.

Streams: compute runs on the calling thread's current CUDA stream (the
kernels take that stream too); the transfer thread copies on its own
stream. A tensor allocated on the transfer stream and read on the compute
stream is marked with ``record_stream``, so the caching allocator does not
hand its memory back to the transfer stream while compute still reads it.
"""
from __future__ import annotations

import contextlib
import time
from functools import partial
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.cache import HostCache
from repro_torch.core.counters import Counters, PhaseTimer
from repro_torch.core.plan import PartitionPlan, WorkUnit
from repro_torch.core.storage import StorageTier
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dispatch import KernelDispatch
from repro_torch.models.gnn.layers import apply_with
from repro_torch.runtime.config import PipelineConfig


def act_file(layer: int) -> str:
    """Canonical per-layer activation file name (shared with the engine)."""
    return f"act{layer}"


class StackedGather(NamedTuple):
    """Kernel-path host staging product: whole cached partition blocks
    memcpy'd back to back (``stack``, a pooled buffer with one zeroed pad
    row at the end) plus the unit's layer-independent row map ``idx``
    (``(r_pad,) int32``, cached — NOT pool-owned) such that
    ``stack[idx] == GA_p`` bitwise; ``side`` the unit's side-input rows
    (:meth:`ForwardRunner.side_rows`, pooled) or None."""

    stack: np.ndarray
    idx: np.ndarray
    side: Optional[np.ndarray] = None


class WithSide(NamedTuple):
    """The padded gather's product for a module that reads a side input:
    the ``GA`` buffer and the side rows, both pooled."""

    ga: np.ndarray
    side: np.ndarray


def split_side(obj):
    """``(ga, side)`` of a padded gather's product (``side`` None where the
    module reads none)."""
    if isinstance(obj, WithSide):
        return obj.ga, obj.side
    return obj, None


def unit_row_map(plan: PartitionPlan, u: WorkUnit):
    """Layer-independent row map for the kernel path: ``idx[i]`` is the
    stack row holding GA row ``i`` (partition blocks laid back to back in
    ``u.req_parts`` order); padding rows ``[n_req, r_pad)`` point at the
    stack's dedicated zeroed row at offset ``total``. Returns
    ``(idx, block sizes, total)``."""
    ptr = u.req_part_ptr
    sizes = []
    total = 0
    offs = {}
    for q in u.req_parts:
        a0, a1 = plan.ro.partition_slice(int(q))
        offs[int(q)] = total
        sizes.append(a1 - a0)
        total += a1 - a0
    idx = np.full(u.r_pad, total, np.int32)
    for q in u.req_parts:
        a0, _ = plan.ro.partition_slice(int(q))
        idx[ptr[q] : ptr[q + 1]] = (
            offs[int(q)] + (u.req_global[ptr[q] : ptr[q + 1]] - a0)
        ).astype(np.int32)
    return idx, sizes, total


class ForwardRunner:
    def __init__(
        self,
        spec,
        plan: PartitionPlan,
        dims,
        storage: StorageTier,
        cache: HostCache,
        counters: Counters,
        rt,                       # PipelineExecutor (owned by the driver)
        pipeline: PipelineConfig,
        dtype=np.float32,
        store_dtype=None,
        act_kind: str = "act",
        act_name: Callable[[int], str] = act_file,
        kernels: Optional[KernelDispatch] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self.spec = spec
        self.plan = plan
        self.dims = list(dims)
        self.n_layers = len(self.dims) - 1
        self.storage = storage
        self.cache = cache
        self.counters = counters
        self._rt = rt
        self.pipeline = pipeline
        self.dtype = np.dtype(dtype)
        self.store_dtype = (
            np.dtype(store_dtype) if store_dtype is not None else self.dtype
        )
        self.act_kind = act_kind
        self.act_name = act_name
        self._use_xfer = pipeline.enabled and pipeline.transfer_stage
        # the transfer thread's own stream (H2D copies overlap compute)
        self._xfer_stream = (
            torch.cuda.Stream(self.device)
            if self._cuda and self._use_xfer else None
        )
        self.kernels = (
            kernels
            if kernels is not None
            else KernelDispatch(pipeline.kernels, counters, self.device)
        )
        # (layer, p) -> keys the prefetch stage actually pinned for that
        # unit; the gather stage pops and releases exactly these (prefetch
        # of a unit strictly precedes its gather via the stage queues)
        self.prefetch_pins: Dict = {}
        self._fwd = {}
        # kernel path: per-unit (idx, sizes, total) row maps and their
        # device-resident copies — layer-independent (plan-derived), so one
        # H2D per unit for the whole run
        self._idx_cache: Dict = {}
        self._idx_dev_cache: Dict = {}

    # ------------------------------------------------------------- layer fn
    def fwd_fn(self, activate: bool):
        if activate not in self._fwd:
            apply = self.spec.apply_layer

            def f(layer, ga, topo, side=None):
                return apply_with(apply, layer, ga, topo, activate, side)

            self._fwd[activate] = f
        return self._fwd[activate]

    # --------------------------------------------------------------- gather
    def load_part_block(self, layer: int, q: int) -> np.ndarray:
        a0, a1 = self.plan.ro.partition_slice(q)
        return self.storage.read_rows(self.act_name(layer), a0, a1)

    def block_nbytes(self, layer: int, q: int) -> int:
        """On-storage (= in-cache) size of partition q's block of layer
        ``layer`` — what the prefetch stage reserves before loading."""
        a0, a1 = self.plan.ro.partition_slice(q)
        return (a1 - a0) * self.dims[layer] * self.store_dtype.itemsize

    def gather(self, layer: int, u: WorkUnit, pad_rows: int) -> np.ndarray:
        """Assemble GA_p^{layer} from the partition cache (paper's host-side
        gather: one sequential run per source partition). The output buffer
        comes from the runtime pool — the caller returns it via
        ``rt.pool.release`` once the device has consumed it."""
        d = self.dims[layer]
        buf = self._rt.pool.acquire((pad_rows, d), self.dtype)
        buf[u.n_req :] = 0  # rows [0, n_req) are fully overwritten below
        ptr = u.req_part_ptr
        copy_ns = 0
        for q in u.req_parts:
            block = self.cache.get(
                (self.act_kind, layer, int(q)),
                loader=partial(self.load_part_block, layer, int(q)),
                size_hint=self.block_nbytes(layer, int(q)),
            )
            a0, _ = self.plan.ro.partition_slice(int(q))
            rows = u.req_global[ptr[q] : ptr[q + 1]] - a0
            t0 = time.perf_counter_ns()
            if block.dtype == buf.dtype:
                # np.take releases the GIL for numeric dtypes (unlike
                # advanced indexing), letting worker-thread gathers overlap
                # the compute loop; mode="clip" skips the bounds-check path
                # (rows are plan-valid)
                np.take(block, rows, axis=0, out=buf[ptr[q] : ptr[q + 1]],
                        mode="clip")
            else:
                # reduced-precision storage: upcast into the compute buffer
                buf[ptr[q] : ptr[q + 1]] = block[rows]
            copy_ns += time.perf_counter_ns() - t0
        # release exactly the pins the prefetch stage took for THIS unit
        # (none in serial mode or when a prefetch couldn't keep residency)
        for key in self.prefetch_pins.pop((layer, u.p), ()):
            self.cache.unpin(key)
        # bump_many(): gathers may run on several pipeline workers at once
        self.counters.bump_many(
            host_gather_bytes=u.n_req * d * self.dtype.itemsize,
            host_copy_ns=copy_ns,
        )
        return buf

    def gather_padded(self, layer: int, u: WorkUnit, phase: str):
        """:meth:`gather` at ``r_pad`` rows, as a :class:`WithSide` with
        the side rows where module ``layer`` reads a side input."""
        with PhaseTimer(self.counters, phase):
            ga = self.gather(layer, u, u.r_pad)
            side = self.side_rows(layer, u)
            return ga if side is None else WithSide(ga, side)

    # ----------------------------------------------------------- side input
    def side_layer(self, layer: int) -> Optional[int]:
        """The layer whose own-vertex rows module ``layer`` reads beside
        ``GA`` (``GNNSpec.side_input``), or None."""
        return self.spec.side_layer(layer, self.n_layers)

    def _load_side(self, layer: int, q: int) -> np.ndarray:
        """A side input's block read from storage for the side alone."""
        block = self.load_part_block(layer, q)
        self.counters.bump("residual_read_bytes", block.nbytes)
        return block

    def side_rows(self, layer: int, u: WorkUnit) -> Optional[np.ndarray]:
        """The side input of module ``layer`` for unit ``u``: the side
        layer's rows of the unit's own vertices (one contiguous block, the
        unit's own partition), through the cache, into a pooled ``(d_pad,
        d)`` buffer whose rows past ``n_dst`` are zero. None where the
        module reads no side input. Releases the pin the prefetch stage
        took for it."""
        k = self.side_layer(layer)
        if k is None:
            return None
        t0 = time.perf_counter()
        d = self.dims[k]
        block = self.cache.get(
            (self.act_kind, k, u.p), loader=partial(self._load_side, k, u.p),
            size_hint=self.block_nbytes(k, u.p),
        )
        buf = self._rt.pool.acquire((u.d_pad, d), self.dtype)
        tc = time.perf_counter_ns()
        buf[: u.n_dst] = block      # upcasts reduced-precision storage
        buf[u.n_dst :] = 0
        copy_ns = time.perf_counter_ns() - tc
        for key in self.prefetch_pins.pop(("side", layer, u.p), ()):
            self.cache.unpin(key)
        self.counters.bump_many(
            residual_rows=u.n_dst,
            host_gather_bytes=u.n_dst * d * self.dtype.itemsize,
            host_copy_ns=copy_ns,
        )
        tracer = self.counters.tracer
        if tracer.enabled:
            tracer.complete("residual", time.perf_counter() - t0,
                            args={"layer": layer, "p": u.p})
        return buf

    # ------------------------------------------------- stacked gather (kernel)
    def _unit_idx(self, u: WorkUnit):
        """:func:`unit_row_map` of ``u``, cached per unit — it only depends
        on the plan."""
        ent = self._idx_cache.get(u.p)
        if ent is None:
            ent = unit_row_map(self.plan, u)
            self._idx_cache[u.p] = ent
        return ent

    def idx_dev(self, u: WorkUnit) -> torch.Tensor:
        """Device-resident copy of the unit's row map (one H2D ever, a
        blocking copy on the calling thread's current stream; the host idx
        is never mutated, so on the CPU a zero-copy alias is fine)."""
        dev = self._idx_dev_cache.get(u.p)
        if dev is None:
            idx, _, _ = self._unit_idx(u)
            dev = torch.from_numpy(idx).to(self.device)
            self.counters.bump("h2d_bytes", idx.nbytes)
            self._idx_dev_cache[u.p] = dev
        return dev

    def stacked_gather(self, layer: int, u: WorkUnit) -> StackedGather:
        """Kernel-path host staging: instead of indexing rows out of every
        cached partition block (the reference :meth:`gather`'s intermediate
        gathered copy), memcpy the whole blocks back to back into one pooled
        (pinned) stack buffer and let the device kernel index rows out of
        the staged stack directly (``gather_rows(stack, idx) == GA_p``
        bitwise). Contiguous block copies release the GIL and skip the
        per-row indexing entirely; the row selection moves into the
        kernel. The stack can be as large as the whole layer table (every
        partition block), so ``pool_max_bytes`` and ``device_slots`` are
        sized for it by the caller."""
        d = self.dims[layer]
        idx, sizes, total = self._unit_idx(u)
        buf = self._rt.pool.acquire((total + 1, d), self.dtype)
        off = copy_ns = 0
        for q, sz in zip(u.req_parts, sizes):
            block = self.cache.get(
                (self.act_kind, layer, int(q)),
                loader=partial(self.load_part_block, layer, int(q)),
                size_hint=self.block_nbytes(layer, int(q)),
            )
            t0 = time.perf_counter_ns()
            if block.dtype == buf.dtype:
                np.copyto(buf[off : off + sz], block)
            else:
                # reduced-precision storage: upcast into the compute buffer
                buf[off : off + sz] = block
            copy_ns += time.perf_counter_ns() - t0
            off += sz
        buf[total] = 0   # the pad row every idx >= n_req points at
        for key in self.prefetch_pins.pop((layer, u.p), ()):
            self.cache.unpin(key)
        self.counters.bump_many(
            host_gather_bytes=total * d * self.dtype.itemsize,
            host_copy_ns=copy_ns,
        )
        return StackedGather(buf, idx)

    def stacked_gather_timed(
        self, layer: int, u: WorkUnit, phase: str
    ) -> StackedGather:
        """:meth:`stacked_gather` with the side rows where module ``layer``
        reads a side input."""
        with PhaseTimer(self.counters, phase):
            sg = self.stacked_gather(layer, u)
            side = self.side_rows(layer, u)
            return sg if side is None else sg._replace(side=side)

    def prefetch_unit(self, layer: int, u: WorkUnit) -> None:
        """Stage-1: make (and keep) the unit's source partitions resident.
        With ``batched_reads`` every missing partition is fetched in ONE
        vectored storage submission instead of one read per partition; block
        sizes are passed so the cache reserves room BEFORE the blocks are
        materialized (host memory never transiently exceeds the budget)."""
        pin = self.pipeline.pin_prefetched
        if not pin and self.pipeline.slow_lane_pin:
            # degradation: while the storage lane is flagged slow (EWMA
            # latency spike on the I/O queue), force this unit's blocks
            # cache-resident so the slow device isn't re-read for data the
            # host already holds
            w = getattr(self._rt, "writer", None)
            if w is not None and w.slow_lane:
                pin = True
                self.counters.bump("slow_lane_pins")
        keys = [(self.act_kind, layer, int(q)) for q in u.req_parts]
        # a side input's block, where no gather of the unit reads it
        side = self.side_layer(layer)
        side_key = None
        if side is not None and side != layer:
            side_key = (self.act_kind, side, u.p)
            keys.append(side_key)
        if self.pipeline.batched_reads:
            sizes = {k: self.block_nbytes(k[1], k[2]) for k in keys}

            def batch_loader(missing):
                reqs = []
                for (_, kl, q) in missing:
                    a0, a1 = self.plan.ro.partition_slice(q)
                    reqs.append((self.act_name(kl), a0, a1))
                blocks = self.storage.read_rows_batched(reqs)
                if side_key in missing:
                    self.counters.bump(
                        "residual_read_bytes",
                        blocks[missing.index(side_key)].nbytes)
                return blocks

            res = self.cache.prefetch_many(
                keys, batch_loader, pin=pin, sizes=sizes
            )
            pinned = [k for k in keys if res.get(k)] if pin else []
        else:
            pinned = []
            for key in keys:
                load = self._load_side if key == side_key \
                    else self.load_part_block
                resident = self.cache.prefetch(
                    key,
                    loader=partial(load, key[1], key[2]),
                    pin=pin,
                    size_hint=self.block_nbytes(key[1], key[2]),
                )
                if pin and resident:
                    pinned.append(key)
        if side_key in pinned:
            pinned.remove(side_key)
            self.prefetch_pins[("side", layer, u.p)] = [side_key]
        if pinned:
            self.prefetch_pins[(layer, u.p)] = pinned

    # ------------------------------------------------------- fault unwinding
    def release_pins(self) -> None:
        """Unwind path: unpin every prefetched block whose gather never ran
        (aborted pipeline). Idempotent; called after the stage threads are
        joined, so no gather is concurrently popping entries."""
        while self.prefetch_pins:
            try:
                _, keys = self.prefetch_pins.popitem()
            except KeyError:  # pragma: no cover - raced with a live gather
                break
            for key in keys:
                self.cache.unpin(key)

    def release_gather(self, obj) -> None:
        """Unwind path: hand any stranded gather product back to the buffer
        pool. Handles every shape the stream stages carry — pooled ndarrays,
        :class:`StackedGather` (only ``stack`` is pool-owned), and
        post-transfer tuples (device tensors and events are skipped; the
        pool's release guards make an over-eager call on a non-pool object a
        counted no-op).
        """
        if obj is None:
            return
        if isinstance(obj, StackedGather):
            self._rt.pool.release(obj.stack)
            self.release_gather(obj.side)
            return
        if isinstance(obj, tuple):
            for o in obj:
                self.release_gather(o)
            return
        if isinstance(obj, np.ndarray):
            self._rt.pool.release(obj)

    def _cleanup_stream(self, _u, buf, aux) -> None:
        """``run_stream`` cleanup_fn: release the pooled buffers of a unit
        stranded in flight when the pipeline unwound."""
        self.release_gather(buf)
        self.release_gather(aux)

    # ----------------------------------------------------- transfer staging
    def _xfer_ctx(self):
        """Run the enclosed copies on the transfer stream (CUDA only)."""
        if self._xfer_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._xfer_stream)

    def stage_h2d(self, arr: np.ndarray, defer: bool = True):
        """Stage a pooled host buffer onto the device; returns
        ``(tensor, event)``.

        On a CUDA device: a ``non_blocking`` copy from the pinned buffer on
        the calling thread's current stream (the transfer stream on the
        transfer thread), and a CUDA event recorded right after it. With
        ``defer`` the buffer goes back to the pool with that event — it is
        recycled only once the copy has completed. On the CPU the copy is a
        plain ``clone`` (so the tensor never aliases a recycled buffer) and
        there is no event.

        ``defer=False`` (snapshot mode's keep-host staging) leaves the
        buffer's ownership with the caller, who releases it with the
        event."""
        src = torch.from_numpy(arr)
        if self._cuda:
            dev = torch.empty(arr.shape, dtype=src.dtype, device=self.device)
            dev.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        else:
            dev, ev = src.clone(), None
        self.counters.bump("h2d_bytes", arr.nbytes)
        if defer:
            self._rt.pool.release(arr, event=ev)
        return dev, ev

    def stage_side(self, side: Optional[np.ndarray]):
        """:meth:`stage_h2d` of a unit's side rows (None: none); a later
        copy's event on the same stream covers it."""
        return None if side is None else self.stage_h2d(side)[0]

    def _await(self, ev, *tensors) -> None:
        """Compute side of a staged unit: make the current stream wait on
        the transfer's event, and mark the staged tensors (None: none) as
        used on it."""
        if ev is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ev)
        for t in tensors:
            if t is not None:
                t.record_stream(cur)

    def _make_transfer_fn(self, keep_host: bool):
        def transfer(u: WorkUnit, ga, _aux):
            """H2D staging for one forward unit (runs on the transfer
            thread): enqueue the copy on the transfer stream while the
            previous unit's kernels run, and wait for it here (this thread
            only) so the ``h2d`` busy time is the copy's real duration. The
            host buffer goes back to the pool, unless the driver's
            ``after_compute`` hook still needs it (snapshot mode). The side
            rows, if any, go first: GA's event covers both copies."""
            ga, side = split_side(ga)
            with self._xfer_ctx():
                side_dev = self.stage_side(side)
                dev, ev = self.stage_h2d(ga, defer=not keep_host)
            if ev is not None:
                ev.synchronize()
            return (dev, ga if keep_host else None, side_dev, ev), None

        return transfer

    def _make_stacked_transfer_fn(self):
        def transfer(u: WorkUnit, sg: StackedGather, _aux):
            # the row map first (device-resident after the unit's first
            # layer), the side rows, then the stack: the stack's event
            # covers them all
            with self._xfer_ctx():
                idx_dev = self.idx_dev(u)
                side_dev = self.stage_side(sg.side)
                stack_dev, ev = self.stage_h2d(sg.stack)
            if ev is not None:
                ev.synchronize()
            return (stack_dev, idx_dev, side_dev, ev), None

        return transfer

    # -------------------------------------------------------------- forward
    def run_layer(
        self,
        l: int,
        params_l,
        activate: bool,
        after_compute: Optional[Callable[[WorkUnit, np.ndarray], None]] = None,
        out_name: Optional[str] = None,
    ) -> None:
        """Stream one forward layer pass: gather GA^l for every scheduled
        unit, apply the layer, and bypass-write the output activations to
        ``out_name`` (default ``act{l+1}``).

        ``after_compute(u, ga_host)`` runs on the compute loop with the
        unit's host gather buffer still alive (the transfer stage is told to
        keep it) — the training engine's snapshot persist hook. The runner
        releases the buffer afterwards.

        Ends with a write barrier and an invalidation of cached blocks of
        the output layer (they would be stale for any later reader).
        """
        rt = self._rt
        use_xfer = self._use_xfer
        keep_host = after_compute is not None
        # kernel dispatch: stack-consuming forward. Snapshot mode
        # (keep_host) needs GA materialized on the host for persistence —
        # exactly the copy the fused path eliminates — so it stays on the
        # reference host gather (a documented dispatch rule).
        use_stacked = self.kernels.use_kernels and not keep_host
        t_layer = time.perf_counter()
        name_out = out_name if out_name is not None else self.act_name(l + 1)
        cast = self.store_dtype != self.dtype
        if use_stacked:
            fwd = self.kernels.fused_forward_fn(self.spec, activate)
            gather_fn = lambda u, _l=l: self.stacked_gather_timed(
                _l, u, "gather"
            )
            transfer_fn = self._make_stacked_transfer_fn()
        else:
            fwd = self.fwd_fn(activate)
            gather_fn = lambda u, _l=l: self.gather_padded(_l, u, "gather")
            transfer_fn = self._make_transfer_fn(keep_host)
        units = [self.plan.unit(p) for p in self.plan.schedule]
        prefetch_fn = (
            (lambda u, _l=l: self.prefetch_unit(_l, u))
            if self.pipeline.enabled else None
        )
        try:
            self._run_layer_stream(
                l, params_l, fwd, activate, after_compute, name_out, cast,
                units, gather_fn, prefetch_fn, transfer_fn, use_xfer,
                use_stacked, keep_host,
            )
        except BaseException:
            # faulted epoch: pins taken by prefetches whose gather never ran
            # must not outlive the stream (HostCache pins return to zero —
            # the deadlock regression suite's contract)
            self.release_pins()
            raise
        # barrier: the next layer reads name_out — all writes must be down
        # (drain_writes retires pending D2H copies first)
        rt.drain_writes()
        # the output layer was just rewritten: cached blocks of it (loaded
        # by a previous epoch's gathers) are stale — drop before any reader
        self.cache.drop_layer(self.act_kind, l + 1, flush=False)
        rt.loop.lap("barrier")
        tracer = self.counters.tracer
        if tracer.enabled:
            tracer.complete("fwd_layer", time.perf_counter() - t_layer,
                            args={"layer": l, "units": len(units)})

    def _run_layer_stream(
        self, l, params_l, fwd, activate, after_compute, name_out, cast,
        units, gather_fn, prefetch_fn, transfer_fn, use_xfer, use_stacked,
        keep_host,
    ) -> None:
        rt = self._rt
        loop, dclock = rt.loop, rt.device_clock
        for u, ga, _ in rt.run_stream(
            units, gather_fn, prefetch_fn,
            transfer_fn=transfer_fn if use_xfer else None,
            cleanup_fn=self._cleanup_stream,
            wait_stage="compute_wait_fwd",
            xfer_wait_stage="compute_wait_xfer_fwd",
            xfer_up_stage="xfer_wait_up_fwd",
        ):
            ev_host = None
            with torch.no_grad():
                if use_stacked:
                    ga_host = None
                    if use_xfer:
                        stack_dev, idx_dev, side_dev, ev = ga
                        self._await(ev, stack_dev, idx_dev, side_dev)
                    else:
                        idx_dev = self.idx_dev(u)
                        side_dev = self.stage_side(ga.side)
                        stack_dev, _ = self.stage_h2d(ga.stack)
                        loop.lap("fetch")
                    dclock.start()
                    out = fwd(params_l, stack_dev, idx_dev, u.topo, side_dev)
                elif use_xfer:
                    ga_dev, ga_host, side_dev, ev_host = ga
                    self._await(ev_host, ga_dev, side_dev)
                    dclock.start()
                    out = fwd(params_l, ga_dev, u.topo, side_dev)
                else:
                    ga_host, side = split_side(ga)
                    side_dev = self.stage_side(side)
                    ga_dev, ev_host = self.stage_h2d(ga_host,
                                                     defer=not keep_host)
                    loop.lap("fetch")
                    dclock.start()
                    out = fwd(params_l, ga_dev, u.topo, side_dev)
                dclock.stop("fwd")
                out_dst = out[: u.n_dst]
                loop.lap("launch")
                if use_xfer and self.pipeline.async_d2h and not cast:
                    # the retire thread waits on the D2H copy's event and
                    # runs the bypass write
                    out_np = None
                else:
                    out_np = out_dst.cpu().numpy()
                    loop.lap("sync")
                    self.counters.bump("d2h_bytes", out_np.nbytes)
                    if cast:
                        # reduced-precision storage: downcast before the
                        # bypass write (out_np is freshly owned)
                        out_np = out_np.astype(self.store_dtype)
            if after_compute is not None:
                after_compute(u, ga_host)
            if keep_host and ga_host is not None:
                # kept for after_compute; recycled once its H2D copy landed
                rt.pool.release(ga_host, event=ev_host)
            # bypass: output activations go straight to storage
            # (write-behind when pipelined; out_np is freshly owned)
            if out_np is None:
                rt.retire_write(name_out, u.v0, out_dst)
            else:
                rt.write_rows(name_out, u.v0, out_np)
            loop.lap("write")
