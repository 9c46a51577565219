"""Storage-offloaded full-graph layer-wise inference.

The deployment companion to the SSO training engine: compute every node's
final-layer embedding for a graph whose activation state exceeds host
memory, by streaming the same cache→gather→transfer→compute→bypass pipeline
(:class:`repro_torch.runtime.forward.ForwardRunner`) layer by layer — DGL's
offline ``inference()`` pattern on the GriNNder substrate, with the layer
compute on the CUDA card (``device``; the CPU only when asked for).

Being forward-only buys three things training can't have:

- **No gradient state.** No regather/snapshot plumbing, no grad files, no
  write-back buffers — the host cache serves only activation blocks.
- **Per-layer storage truncation** (``free_consumed``, default on): layer
  ``l-1``'s activation file is freed (and its cached blocks dropped) as
  soon as layer ``l`` finishes, so at most two layer files plus the input
  exist at once — ≈half the training forward's storage footprint for deep
  models (``Counters.storage_peak_alloc_bytes`` measures it). A layer that
  later modules read as their side input (GCNII's ``H^0``) is freed after
  the last of them, so it is a third file while they run.
- **Reduced-precision storage** (``store_dtype=np.float16``): on-storage
  activations and the served embedding table are stored at half width;
  gathers upcast to the fp32 compute dtype, bypass writes downcast. Halves
  both the NVMe traffic and the host-cache footprint per block.

The output is bit-identical between a pipelined and a serial run, and
between the ``kernel`` and ``reference`` dispatch modes — same schedule,
same ``GA_p``, deterministic layer math; truncation does not change the
math either, it only deletes files the forward has already consumed.

The finished embedding table lands in the storage file ``final_name``
(default ``"emb"``), ready to be served by
:class:`repro_torch.infer.server.EmbeddingServer`.
"""
from __future__ import annotations

import time
from typing import List, Optional, Union

import numpy as np

from repro_torch.core.cache import HostCache
from repro_torch.core.counters import Counters, PhaseTimer
from repro_torch.core.plan import PartitionPlan
from repro_torch.core.storage import StorageTier
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn.layers import GNNSpec
from repro_torch.obs import EpochSummarizer, Tracer
from repro_torch.runtime.config import PipelineConfig
from repro_torch.runtime.executor import PipelineExecutor
from repro_torch.runtime.forward import ForwardRunner, act_file


class OffloadedInference:
    def __init__(
        self,
        spec: GNNSpec,
        plan: PartitionPlan,
        dims,                      # [d_in, d_h1, ..., d_out]
        storage: StorageTier,
        cache: HostCache,
        counters: Optional[Counters] = None,
        pipeline: Union[PipelineConfig, int, None] = None,
        dtype=np.float32,
        store_dtype=None,
        free_consumed: bool = True,
        keep_input: bool = True,
        final_name: str = "emb",
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
        self.spec = spec
        self.plan = plan
        self.dims = list(dims)
        self.n_layers = len(dims) - 1
        self.storage = storage
        self.cache = cache
        self.counters = counters or storage.counters
        self.dtype = np.dtype(dtype)
        self.store_dtype = (
            np.dtype(store_dtype) if store_dtype is not None else self.dtype
        )
        self.free_consumed = free_consumed
        # the module after which each activation layer has no reader left:
        # its own consumer, or the last module that reads it as a side input
        self._last_read = {j: j for j in range(self.n_layers)}
        for i in range(self.n_layers):
            k = spec.side_layer(i, self.n_layers)
            if k is not None:
                self._last_read[k] = max(self._last_read[k], i)
        self.keep_input = keep_input
        self.final_name = final_name
        if pipeline is None:
            pipeline = PipelineConfig(depth=0)
        elif isinstance(pipeline, int):
            pipeline = PipelineConfig(depth=pipeline)
        self.pipeline = pipeline
        # observability: same wiring as SSOEngine — a trace path swaps the
        # counters' no-op tracer for a live one, exported on close()
        self._trace_path = pipeline.trace
        if pipeline.trace:
            self.counters.tracer = Tracer(
                ring_events=pipeline.trace_ring_events
            )
        self._summarizer = EpochSummarizer(self.counters)
        self._rt = PipelineExecutor(pipeline, self.counters, storage, cache,
                                    device=self.device)
        # inference never creates dirty entries, so it needs no spill queue
        # of its own; wire the writer only when the cache has none (and
        # remember, so close() never severs a queue some other engine owns
        # — replacing an existing queue would split spill writes and the
        # owner's reads across two FIFOs)
        self._wired_spill = False
        if self._rt.writer is not None and cache.spill_queue is None:
            cache.set_spill_queue(self._rt.writer)
            self._wired_spill = True
        self.runner = ForwardRunner(
            spec, plan, self.dims, storage, cache, self.counters, self._rt,
            pipeline, dtype=self.dtype, store_dtype=self.store_dtype,
            device=self.device,
        )

    # -------------------------------------------------------------- storage
    def initialize(self, x_reordered: np.ndarray) -> None:
        """Write input features (already permuted by ``plan.ro.perm``) to
        the layer-0 activation file partition-wise, downcasting when a
        reduced on-storage precision is configured. Activation files for
        deeper layers are allocated lazily, one layer ahead of the compute
        (see :meth:`run`) — that is what makes truncation a footprint win."""
        n = self.plan.n_nodes
        name = act_file(0)
        if self.storage.exists(name):
            self.storage.free(name)
        self.storage.alloc(name, (n, self.dims[0]), self.store_dtype)
        for p in range(self.plan.n_parts):
            u = self.plan.unit(p)
            block = x_reordered[u.v0 : u.v1]
            if block.dtype != self.store_dtype:
                block = block.astype(self.store_dtype)
            self.storage.write_rows(name, u.v0, block)
        # stale blocks from a previous run (or a training engine sharing
        # this cache) must not shadow the freshly written features
        self.cache.drop_layer(self.runner.act_kind, 0, flush=False)

    # ---------------------------------------------------------------- infer
    def run(self, params: List) -> str:
        """Compute all layers (``params``: one layer module per layer, e.g.
        ``spec.init(...)`` or ``params_from_jax(...)``, on ``device``);
        returns the storage name of the final-layer embedding table
        (``final_name``). Repeatable: each call re-allocates the per-layer
        outputs (``keep_input`` retains ``act0`` so a second ``run`` needs
        no re-``initialize``)."""
        n = self.plan.n_nodes
        st = self.storage
        L = self.n_layers
        t0 = time.perf_counter()
        loop, dclock = self._rt.loop, self._rt.device_clock
        loop.mark()
        dclock.arm()
        with PhaseTimer(self.counters, "infer"):
            for l in range(L):
                last = l == L - 1
                name_out = self.final_name if last else act_file(l + 1)
                if st.exists(name_out):
                    st.free(name_out)
                st.alloc(name_out, (n, self.dims[l + 1]), self.store_dtype)
                loop.lap("barrier")
                self.runner.run_layer(
                    l, params[l], activate=not last, out_name=name_out,
                )
                if not self.free_consumed:
                    continue
                for j, last_l in self._last_read.items():
                    if last_l != l or (j == 0 and self.keep_input):
                        continue
                    # layer j's activations were fully consumed by the
                    # gathers above (run_layer drained all writes): truncate
                    self.cache.drop_layer(self.runner.act_kind, j, flush=False)
                    st.free(act_file(j))
                    loop.lap("barrier")
            # tracer on, on the card: the units' device times (one event
            # wait)
            dclock.resolve()
            loop.lap("sync")
        self._summarizer.log_epoch(time.perf_counter() - t0)
        return self.final_name

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        try:
            self._rt.close()
        finally:
            if self._wired_spill:
                self.cache.set_spill_queue(None)
            tr = self.counters.tracer
            if self._trace_path and tr.enabled:
                tr.export_chrome_trace(self._trace_path)
