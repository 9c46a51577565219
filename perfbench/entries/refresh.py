"""The embedding refresh: one step is ``OffloadedInference.run`` over every
node (the layer-wise forward the embedding server serves from), ended by a
device synchronise.

Set-up builds the engine and runs one refresh, untimed, that builds and
warms every kernel. The comparison holds the table of that first refresh
and of the window's last against the reference's forward, every node.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench import compare, harness, reference


class Entry:
    e2e = "refresh_s"

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.timings = {}

    def setup(self) -> None:
        from repro_torch.infer import OffloadedInference
        from repro_torch.models.gnn.layers import get_gnn

        cfg, tr, dev = self.config, self.traffic, self.device
        t0 = time.perf_counter()
        self.inputs = inp = harness.make_inputs(cfg, tr, self.seed, dev)
        self.timings["inputs_s"] = time.perf_counter() - t0
        self.plan, self.parts = harness.program_graph(
            cfg, tr, inp, dev, self.timings)
        self.counters, self.storage, cache = harness.program_storage(tr)
        self.engine = OffloadedInference(
            get_gnn(cfg["model"]), self.plan, cfg["dims"], self.storage,
            cache, self.counters, pipeline=harness.pipeline_config(tr),
            device=dev)
        t0 = time.perf_counter()
        self.engine.initialize(inp.x[self.plan.ro.perm])
        self.timings["initialize_s"] = time.perf_counter() - t0
        self.params = harness.program_params(cfg, inp, dev)
        t0 = time.perf_counter()
        self.step()
        self.timings["first_refresh_s"] = time.perf_counter() - t0
        self.tables = [self._table()]

    def _table(self) -> np.ndarray:
        return np.array(self.storage.read_rows(self.name, 0,
                                               self.plan.n_nodes))

    def step(self) -> None:
        import torch

        self.name = self.engine.run(self.params)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        try:
            self.tables.append(self._table())
            self.engine.close()
        finally:
            self.storage.close()
        self.engine = self.storage = self.params = None

    def reference(self, **precision) -> np.ndarray:
        return reference.embeddings(self.config, self.inputs, self.device,
                                    **precision)

    def check(self, ref=None) -> dict:
        """The worst of the checked tables' numbers. The program's row
        ``i`` is the node the reference's stable sort of the partition
        vector puts at ``i``."""
        ref = self.reference() if ref is None else ref
        order = np.argsort(self.parts, kind="stable")
        nums = [compare.table_numbers(t, ref[order]) for t in self.tables]
        return {k: max(n[k] for n in nums) for k in nums[0]}
