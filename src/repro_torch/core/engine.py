"""Structured Storage Offloading engine (paper §3–§5), PyTorch/CUDA port.

Implements the cache-(re)gather-bypass workflow with two gradient engines:

- ``mode="regather"`` (GriNNder): forward persists only the canonical
  per-layer activation array ``A^l`` (bypass-written to storage); the backward
  *regathers* ``GA_p^{l-1}`` just-in-time from the partition cache and
  recomputes the layer intermediates inside the vjp
  (:func:`~repro_torch.models.gnn.layers.apply_vjp`) — no snapshots, no
  α-fold amplification.
- ``mode="snapshot"`` (HongTu baseline): forward additionally persists every
  partition's gathered activations ``GA_p^{l-1}``; the backward reads the
  snapshot. Numerically identical, α× more I/O and host footprint.

Both engines drive the same layer functions (models/gnn/layers.py), so the
gradients equal whole-graph autograd up to float reassociation — the paper's
"no algorithm change" property (Appendix W).

The forward pass is the shared
:class:`repro_torch.runtime.forward.ForwardRunner` (the layer pass of
storage-offloaded inference); training hooks its snapshot persist into the
runner's ``after_compute`` and the backward's regather reuses the runner's
gather / stacked gather / prefetch (same cache keys, same pin protocol).

Every layer pass — forward, loss, and backward — streams its work units
through :meth:`PipelineExecutor.run_stream`: prefetch → gather → transfer
worker stages while the calling thread computes in schedule order and
bypass writes retire on a write-behind I/O thread. Loss logits reads and
regather/snapshot fetches run on the gather workers, the ∇A^{l+1} fetch
rides the aux stage, and degraded-mode grad spills (plus dirty cache
evictions) retire on the storage I/O queue, whose FIFO orders later reads
behind them. The transfer stage copies the next unit's inputs (GA or the
partition stack, the ∇A^{l+1} rows, logits and labels) onto the card on
its own CUDA stream from pinned pool buffers while the current unit
computes; the compute stream waits on the copy's event and marks the
staged tensors with ``record_stream``. A pooled buffer goes back to the pool
with its copy's event and is recycled only after it.

``pipeline.depth == 0`` is the serial engine; ``depth >= 1`` (any
``gather_workers``, transfer stage on or off) is bit-identical to serial:
the compute order and every staged buffer are unchanged, device copies are
exact, and every reduction in the layer math and its vjp is deterministic.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.cache import HostCache
from repro_torch.core.counters import Counters, PhaseTimer
from repro_torch.core.plan import PartitionPlan, WorkUnit
from repro_torch.core.storage import StorageTier
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dispatch import KernelDispatch
from repro_torch.models.gnn.layers import GNNSpec, apply_vjp
from repro_torch.obs import EpochSummarizer, Tracer
from repro_torch.runtime.config import PipelineConfig
from repro_torch.runtime.executor import PipelineExecutor
from repro_torch.runtime.forward import ForwardRunner, act_file


def _grad_name(layer: int) -> str:
    return f"grad{layer}"


def _snap_name(layer: int, p: int) -> str:
    return f"snap{layer}_{p}"


class SSOEngine:
    def __init__(
        self,
        spec: GNNSpec,
        plan: PartitionPlan,
        dims: Sequence[int],              # [d_in, d_h1, ..., d_out]
        storage: StorageTier,
        cache: HostCache,
        counters: Optional[Counters] = None,
        mode: str = "regather",
        dtype=np.float32,
        pipeline: Union[PipelineConfig, int, None] = None,
        device: DeviceLike = None,
    ):
        # first: no CUDA device and no explicit device raises before any
        # storage or thread is touched
        self.device = resolve_device(device)
        if plan.device != self.device:
            raise ValueError(
                f"plan topologies live on {plan.device}, engine runs on "
                f"{self.device}: build the plan with device={self.device}"
            )
        if mode not in ("regather", "snapshot"):
            raise ValueError(f"mode={mode!r} not in ('regather', 'snapshot')")
        self.spec = spec
        self.plan = plan
        self.dims = list(dims)
        self.n_layers = len(dims) - 1
        self.storage = storage
        self.cache = cache
        self.counters = counters or storage.counters
        self.mode = mode
        self.dtype = np.dtype(dtype)
        self._materialized_grads: set = set()
        if pipeline is None:
            pipeline = PipelineConfig(depth=0)
        elif isinstance(pipeline, int):
            pipeline = PipelineConfig(depth=pipeline)
        self.pipeline = pipeline
        # observability: a trace path swaps the shared no-op tracer on the
        # counters for a live one; exported on close()
        self._trace_path = pipeline.trace
        if pipeline.trace:
            self.counters.tracer = Tracer(
                ring_events=pipeline.trace_ring_events
            )
        self._summarizer = EpochSummarizer(self.counters)
        self._rt = PipelineExecutor(pipeline, self.counters, storage, cache,
                                    device=self.device)
        self._use_xfer = pipeline.enabled and pipeline.transfer_stage
        if self._rt.writer is not None:
            # dirty cache evictions flush through the write-behind queue so
            # an eviction never stalls pipeline workers on a storage write;
            # grad/snap reads below go through the same FIFO for ordering
            cache.set_spill_queue(self._rt.writer)
        # hot-loop kernel dispatch, shared with the runner so both halves of
        # the pass pick the same path
        self.kernels = KernelDispatch(pipeline.kernels, self.counters,
                                      self.device)
        self.fwd_runner = ForwardRunner(
            spec, plan, self.dims, storage, cache, self.counters, self._rt,
            pipeline, dtype=self.dtype, kernels=self.kernels,
            device=self.device,
        )
        self._prefetch_pins = self.fwd_runner.prefetch_pins

    # ----------------------------------------------------------------- loss
    @staticmethod
    def _loss_grad(logits: torch.Tensor, labels: torch.Tensor,
                   n_total: torch.Tensor):
        """``(loss_p, dL/dlogits)`` of one unit's share of the mean
        cross-entropy: padded rows (label -1) are masked out and the sum is
        divided by the whole graph's node count, so the units' shares add
        up to the full-graph loss."""
        mask = (labels >= 0).to(logits.dtype)
        lg = logits.detach().requires_grad_(True)
        with torch.enable_grad():
            logp = torch.log_softmax(lg, dim=-1)
            ll = logp.gather(1, labels.clamp_min(0).long()[:, None])[:, 0]
            loss = -(ll * mask).sum() / n_total
            (dlog,) = torch.autograd.grad(loss, lg)
        return loss.detach(), dlog

    # -------------------------------------------------------------- storage
    def initialize(self, x_reordered: np.ndarray) -> None:
        """Write input features (already permuted by plan.ro.perm) to storage
        partition-wise, alloc per-layer activation files."""
        n = self.plan.n_nodes
        st = self.storage
        for l, d in enumerate(self.dims):
            name = act_file(l)
            if st.exists(name):
                st.free(name)
            st.alloc(name, (n, d), self.dtype)
        for p in range(self.plan.n_parts):
            u = self.plan.unit(p)
            st.write_rows(act_file(0), u.v0, x_reordered[u.v0 : u.v1])
        # stale blocks from a previous run must not shadow the new features
        self.cache.drop_layer(self.fwd_runner.act_kind, 0, flush=False)
        if self.mode == "snapshot":
            for l in range(self.n_layers):
                for p in range(self.plan.n_parts):
                    u = self.plan.unit(p)
                    name = _snap_name(l, p)
                    if st.exists(name):
                        st.free(name)
                    st.alloc(name, (u.n_req, self.dims[l]), self.dtype)

    # -------------------------------------------------------------- forward
    def forward(self, params) -> None:
        for l in range(self.n_layers):
            after = None
            if self.mode == "snapshot":
                def after(u, ga_host, _l=l):
                    # HongTu: persist GA for the backward pass (α-amplified).
                    # The snapshot is offloaded from the device, so it
                    # transits the device<->host link (paper Table 6:
                    # (2α+1)D forward).
                    self.counters.bump(
                        "d2h_bytes",
                        u.n_req * self.dims[_l] * self.dtype.itemsize,
                    )
                    self._snapshot_put(_l, u.p, ga_host[: u.n_req])
            self.fwd_runner.run_layer(
                l, params[l], activate=(l < self.n_layers - 1),
                after_compute=after,
            )

    # ------------------------------------------------------------ snapshots
    def _snapshot_put(self, layer: int, p: int, ga_real: np.ndarray) -> None:
        name = _snap_name(layer, p)
        # reserve BEFORE the copy (ga_real views a pooled gather buffer that
        # will be recycled): evictions run first and the claim counts toward
        # the budget, so the snapshot copy never overshoots it transiently
        nb = int(ga_real.nbytes)
        reserved = self.cache.reserve(nb)
        snap = np.array(ga_real)
        ok = reserved and self.cache.put(
            ("snap", layer, p), snap, dirty=True, spill_name=name,
            reserved_bytes=nb,
        )
        if not ok:
            # write-behind when pipelined (snap is freshly owned); the
            # forward's layer-boundary drain lands it before any reader
            self._rt.write_rows(name, 0, snap)
            self._materialized_grads.add(("snapdisk", layer, p))

    def _load_snap(self, layer: int, p: int, n_req: int) -> np.ndarray:
        # routed through the I/O queue: a dirty snap eviction spills through
        # the same FIFO, so this read always sees the spilled data
        return self._io_read(_snap_name(layer, p), 0, n_req)

    def _snapshot_prefetch(self, layer: int, u: WorkUnit) -> None:
        """Stage-1 for snapshot-mode backward: warm the unit's snapshot (a
        dirty eviction spilled it to its snap file) before the fetch stage
        needs it, mirroring the regather prefetch."""
        pin = self.pipeline.pin_prefetched
        key = ("snap", layer, u.p)
        resident = self.cache.prefetch(
            key, loader=partial(self._load_snap, layer, u.p, u.n_req), pin=pin,
            size_hint=u.n_req * self.dims[layer] * self.dtype.itemsize,
        )
        if pin and resident:
            self._prefetch_pins[(layer, u.p)] = [key]

    def _snapshot_get(self, layer: int, p: int, u: WorkUnit) -> np.ndarray:
        arr = self.cache.peek(("snap", layer, p))
        if arr is None:
            arr = self._io_read(_snap_name(layer, p), 0, u.n_req)
            self.counters.bump("cache_misses")
        else:
            self.counters.bump("cache_hits")
        buf = self._rt.pool.acquire((u.r_pad, arr.shape[1]), self.dtype)
        buf[: arr.shape[0]] = arr
        buf[arr.shape[0] :] = 0
        for key in self._prefetch_pins.pop((layer, p), ()):
            self.cache.unpin(key)
        return buf

    # ------------------------------------------------------- grad write-back
    def _io_read(self, name: str, a0: int, a1: int) -> np.ndarray:
        """Ranged read routed through the storage I/O queue when pipelined:
        the queue's FIFO orders it behind any in-flight write of the same
        region (degraded-mode grad spills and dirty cache evictions)."""
        w = self._rt.writer
        if w is not None:
            return w.submit_read(name, a0, a1).result()
        return self.storage.read_rows(name, a0, a1)

    def _grad_accumulate(
        self, layer: int, q: int, rows_local: np.ndarray, values: np.ndarray
    ) -> None:
        """Scatter-accumulate ∇A^{layer} rows for source partition q (the
        paper's host write-back buffer with storage spill). The buffer is
        pinned for the duration of the update so a concurrent pipeline-worker
        eviction cannot flush it mid-accumulate."""
        key = ("grad", layer, q)
        a0, a1 = self.plan.ro.partition_slice(q)
        name = _grad_name(layer)
        buf = self.cache.acquire(key)
        if buf is None:
            # reserve before materializing the write-back buffer so the
            # zeros/read never pushes host memory past the cache budget
            nb = (a1 - a0) * self.dims[layer] * self.dtype.itemsize
            reserved = self.cache.reserve(nb)
            try:
                if ("gradmat", layer, q) in self._materialized_grads:
                    buf = self._io_read(name, a0, a1)
                else:
                    buf = np.zeros((a1 - a0, self.dims[layer]), self.dtype)
                    self._materialized_grads.add(("gradmat", layer, q))
            except BaseException:
                if reserved:
                    self.cache.unreserve(nb)
                raise
            ok = reserved and self.cache.put(
                key, buf, dirty=True, pinned=True,
                spill_name=name, spill_row0=a0, reserved_bytes=nb,
            )
            if not ok:
                # degraded mode: read-modify-write on storage. The write
                # retires on the I/O queue (buf is freshly owned and never
                # touched again); later fetches of this region go through
                # the same FIFO, so they see it without blocking here.
                # bump(): accumulates may race pipeline workers' counters
                self.kernels.scatter_add_rows(buf, rows_local, values)
                self._rt.write_rows(name, a0, buf)
                self.counters.bump("host_scatter_bytes", values.nbytes)
                return
        self.kernels.scatter_add_rows(buf, rows_local, values)
        self.cache.release(key)
        self.counters.bump("host_scatter_bytes", values.nbytes)

    def _grad_fetch(self, layer: int, p: int) -> np.ndarray:
        """Read ∇A^{layer} for destination partition p (padded to topo rows).

        Runs on the pipeline's aux-fetch stage when enabled, hiding the
        grad-file read behind the previous unit's compute. The padded output
        comes from the runtime pool; its H2D staging hands it back."""
        with PhaseTimer(self.counters, "grad_fetch"):
            u = self.plan.unit(p)
            key = ("grad", layer, p)
            a0, a1 = u.v0, u.v1
            buf = self.cache.peek(key)
            if buf is None and ("gradmat", layer, p) in self._materialized_grads:
                buf = self._io_read(_grad_name(layer), a0, a1)
            out = self._rt.pool.acquire((u.d_pad, self.dims[layer]), self.dtype)
            if buf is None:       # never materialized: ∇A rows are zero
                out[:] = 0
            else:
                out[: u.n_dst] = buf
                out[u.n_dst :] = 0
            return out

    # -------------------------------------------------------- device staging
    def _stage_bwd(self, l: int, u: WorkUnit, ga, d_out, stacked: bool):
        """H2D of one backward unit's inputs on the calling thread's current
        stream (the transfer stream on the transfer thread): ``∇A^{l+1}``
        first, then GA or (the row map and) the partition stack, whose event
        covers every copy before it. Each pooled buffer goes back to the
        pool with its copy's event. Returns ``((staged, event), d_out_dev)``
        with ``staged`` = ``ga_dev`` or ``(stack_dev, idx_dev)``."""
        runner = self.fwd_runner
        if d_out is None:
            d_out = self._grad_fetch(l + 1, u.p)
        do_dev, _ = runner.stage_h2d(d_out)
        if stacked:
            idx_dev = runner.idx_dev(u)
            stack_dev, ev = runner.stage_h2d(ga.stack)
            return ((stack_dev, idx_dev), ev), do_dev
        ga_dev, ev = runner.stage_h2d(ga)
        return (ga_dev, ev), do_dev

    # ------------------------------------------------------------- backward
    def backward(self, params, labels_reordered: np.ndarray):
        """Returns ``(loss, grads)``: ``loss`` a Python float, ``grads`` one
        ``{param_name: tensor}`` dict per layer (module layout, on the
        engine's device)."""
        plan, st = self.plan, self.storage
        n = plan.n_nodes
        L = self.n_layers
        rt = self._rt
        runner = self.fwd_runner
        dev = self.device
        # grad files per layer (lazily zero-filled via materialization set)
        for l in range(L + 1):
            name = _grad_name(l)
            if st.exists(name):
                st.free(name)
            st.alloc(name, (n, self.dims[l]), self.dtype)
        self._materialized_grads.clear()

        # ---- loss layer: dL/dA^L per partition. Logits reads are pipelined
        # through run_stream (busy charged to "loss_fetch"); the dlog
        # write-back lands in the grad cache, spilling through the
        # write-behind queue when degraded.
        total_loss = 0.0
        n_total = torch.tensor(float(n), dtype=torch.float32, device=dev)
        units = [plan.unit(p) for p in plan.schedule]
        use_xfer = self._use_xfer
        tracer = self.counters.tracer
        t_loss = time.perf_counter()

        def loss_fetch(u: WorkUnit) -> np.ndarray:
            logits = st.read_rows(act_file(L), u.v0, u.v1)
            lg = rt.pool.acquire((u.d_pad, self.dims[L]), self.dtype)
            lg[: u.n_dst] = logits
            lg[u.n_dst :] = 0
            return lg

        def stage_loss(u: WorkUnit, lg: np.ndarray):
            # padded labels first, then the logits: the logits' event covers
            # both copies (lb is freshly owned pageable memory: a blocking
            # copy)
            lb = np.full((u.d_pad,), -1, np.int32)
            lb[: u.n_dst] = labels_reordered[u.v0 : u.v1].astype(np.int32)
            lb_dev = torch.from_numpy(lb).to(dev)
            self.counters.bump("h2d_bytes", lb.nbytes)
            lg_dev, ev = runner.stage_h2d(lg)
            return lg_dev, lb_dev, ev

        def loss_transfer(u: WorkUnit, lg: np.ndarray, _aux):
            # stage logits AND padded labels on the transfer thread
            with runner._xfer_ctx():
                staged = stage_loss(u, lg)
            if staged[2] is not None:
                staged[2].synchronize()
            return staged, None

        for u, lg, _ in rt.run_stream(
            units, loss_fetch,
            transfer_fn=loss_transfer if use_xfer else None,
            cleanup_fn=runner._cleanup_stream,
            gather_stage="loss_fetch", wait_stage="compute_wait_loss",
            xfer_wait_stage="compute_wait_xfer_loss",
            xfer_up_stage="xfer_wait_up_loss",
        ):
            lg_dev, lb_dev, ev = lg if use_xfer else stage_loss(u, lg)
            lg = None
            runner._await(ev, lg_dev, lb_dev)
            loss_p, dlog = self._loss_grad(lg_dev, lb_dev, n_total)
            # the D2H copy of dlog's real rows lands while the loss scalar
            # transfers
            dlog_np, d2h_ev = rt._start_d2h(dlog[: u.n_dst])
            total_loss += float(loss_p)
            if d2h_ev is not None:
                d2h_ev.synchronize()
            self.counters.bump("d2h_bytes", dlog_np.nbytes)
            del lg_dev, lb_dev, dlog
            with PhaseTimer(self.counters, "scatter"):
                self._grad_accumulate(L, u.p, np.arange(u.n_dst), dlog_np)
        if tracer.enabled:
            tracer.complete("loss_layer", time.perf_counter() - t_loss,
                            args={"units": len(units)})

        # ---- layers L..1
        grads: List = [None] * L
        # kernel dispatch: the regather backward consumes the partition
        # stack directly (device-side regather + vjp at GA). Snapshot mode
        # reads persisted GA buffers — no partition blocks to stack — so it
        # stays on the reference path (a documented dispatch rule).
        use_stacked = self.kernels.use_kernels and self.mode == "regather"
        for l in range(L - 1, -1, -1):
            t_layer = time.perf_counter()
            activate = l < L - 1
            if use_stacked:
                bwd = self.kernels.fused_backward_fn(self.spec, activate)
            else:
                bwd = partial(apply_vjp, self.spec.apply_layer,
                              activate=activate)
            dW_acc: Optional[Dict[str, torch.Tensor]] = None
            units = [plan.unit(p) for p in plan.schedule]
            if self.mode == "regather":
                if use_stacked:
                    gather_fn = lambda u, _l=l: runner.stacked_gather_timed(
                        _l, u, "regather"
                    )
                else:
                    gather_fn = lambda u, _l=l: runner.gather_padded(
                        _l, u, "regather"
                    )
                prefetch_fn = (
                    (lambda u, _l=l: runner.prefetch_unit(_l, u))
                    if self.pipeline.enabled else None
                )
                gather_stage, prefetch_stage = "regather", "prefetch_bwd"
            else:
                gather_fn = lambda u, _l=l: self._snapshot_get(_l, u.p, u)
                prefetch_fn = (
                    (lambda u, _l=l: self._snapshot_prefetch(_l, u))
                    if self.pipeline.enabled else None
                )
                gather_stage, prefetch_stage = "snap_fetch", "snap_prefetch"
            # aux stage: fetch ∇A^{l+1} on the gather workers. Safe to run
            # ahead — grad layer l+1 was fully accumulated before this
            # stream started, and this stream only scatters into layer l.
            aux_fn = (
                (lambda u, _l=l: self._grad_fetch(_l + 1, u.p))
                if (self.pipeline.enabled and self.pipeline.aux_fetch)
                else None
            )

            def bwd_transfer(u, ga, d_out, _l=l):
                # stage GA (or the partition stack) and ∇A^{l+1} on the
                # transfer thread; when the aux stage is off, its fetch also
                # lands here (still off the compute thread)
                with runner._xfer_ctx():
                    staged, do_dev = self._stage_bwd(_l, u, ga, d_out,
                                                     use_stacked)
                if staged[1] is not None:
                    staged[1].synchronize()
                return staged, do_dev

            for u, ga, d_out in rt.run_stream(
                units, gather_fn, prefetch_fn, aux_fn=aux_fn,
                transfer_fn=bwd_transfer if use_xfer else None,
                cleanup_fn=runner._cleanup_stream,
                prefetch_stage=prefetch_stage, gather_stage=gather_stage,
                aux_stage="grad_fetch", wait_stage="compute_wait_bwd",
                xfer_wait_stage="compute_wait_xfer_bwd",
                xfer_up_stage="xfer_wait_up_bwd",
            ):
                with PhaseTimer(self.counters, "compute_bwd"):
                    if use_xfer:
                        (staged, ev), do_dev = ga, d_out
                    else:
                        # serial staging on the compute stream (the aux
                        # fetch, when off, runs inline here too)
                        (staged, ev), do_dev = self._stage_bwd(
                            l, u, ga, d_out, use_stacked
                        )
                    ga = d_out = None
                    if use_stacked:
                        stack_dev, idx_dev = staged
                        runner._await(ev, stack_dev, idx_dev, do_dev)
                        dp, dga = bwd(params[l], stack_dev, idx_dev, u.topo,
                                      do_dev)
                        del stack_dev, idx_dev
                    else:
                        runner._await(ev, staged, do_dev)
                        dp, dga = bwd(params[l], staged, u.topo, do_dev)
                    # the unit's device inputs are dead: free them before
                    # the next unit stages (layer 0's GA is the widest)
                    staged = do_dev = None
                    # start the D2H copy of ∇GA; it lands under the dW
                    # accumulate
                    dga_np, d2h_ev = rt._start_d2h(dga[: u.n_req])
                    dW_acc = (
                        dp
                        if dW_acc is None
                        else {k: dW_acc[k] + dp[k] for k in dW_acc}
                    )
                    del dga, dp
                    if d2h_ev is not None:
                        d2h_ev.synchronize()
                    self.counters.bump("d2h_bytes", dga_np.nbytes)
                if l > 0:
                    # scatter ∇GA rows back to their source partitions
                    with PhaseTimer(self.counters, "scatter"):
                        ptr = u.req_part_ptr
                        for q in u.req_parts:
                            a0, _ = plan.ro.partition_slice(int(q))
                            rows = u.req_global[ptr[q] : ptr[q + 1]] - a0
                            self._grad_accumulate(
                                l, int(q), rows, dga_np[ptr[q] : ptr[q + 1]]
                            )
                del dga_np
            grads[l] = dW_acc
            # drop consumed grad layer l+1 from cache & storage; barrier
            # first so no queued degraded spill targets the freed file
            self.cache.drop_layer("grad", l + 1, flush=False)
            rt.drain_writes()
            st.free(_grad_name(l + 1))
            if self.mode == "snapshot":
                self.cache.drop_layer("snap", l, flush=False)
            if tracer.enabled:
                tracer.complete("bwd_layer", time.perf_counter() - t_layer,
                                args={"layer": l, "units": len(units)})
        self.cache.drop_layer("grad", 0, flush=False)
        rt.drain_writes()
        st.free(_grad_name(0))
        return total_loss, grads

    # ----------------------------------------------------------------- step
    def run_epoch(self, params, labels_reordered: np.ndarray):
        """One full-graph epoch: forward, loss and backward. ``params`` is
        one layer module per layer on the engine's device (``spec.init`` or
        ``params_from_jax``). Returns ``(loss, grads)`` as :meth:`backward`."""
        t0 = time.perf_counter()
        try:
            with PhaseTimer(self.counters, "epoch"):
                self.forward(params)
                loss, grads = self.backward(params, labels_reordered)
        except BaseException:
            # faulted epoch (fatal storage error, stage crash): the stream's
            # own unwind released stranded buffers; drop any pins taken by
            # prefetches whose gather never ran so cache pins return to zero
            # and the engine stays closeable
            self.fwd_runner.release_pins()
            raise
        # one structured line per epoch (repro_torch.obs logger; silent
        # unless logging is configured): stall top-3, cache hit rate
        self._summarizer.log_epoch(time.perf_counter() - t0)
        return loss, grads

    def close(self) -> None:
        try:
            self._rt.close()
        finally:
            # the runtime's writer is gone: later cache evictions must not
            # submit spills to a closed queue, even if close() raised
            self.cache.set_spill_queue(None)
            tr = self.counters.tracer
            if self._trace_path and tr.enabled:
                tr.export_chrome_trace(self._trace_path)
