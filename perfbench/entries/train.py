"""Full-graph training: one step is ``SSOEngine.run_epoch`` (forward, loss,
regather backward, ∇A write-back) and ``adamw_update``, ended by a device
synchronise.

Set-up builds the one engine, model and optimizer state, drives them from
the seed through the first ``checked_steps`` steps (the first builds and
warms every kernel) and hands the same objects to the window. Those steps
are what the reference follows: each step's loss, the first gradient as
the optimizer holds it after one step (``m / (1 - b1)``) and the
parameters' change after the last of them.
"""
from __future__ import annotations

import time

from perfbench import compare, harness, reference


class Entry:
    e2e = "epoch_s"

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.timings = {}
        self.optim = dict(traffic["optimizer"])

    def setup(self) -> None:
        from repro_torch import optim
        from repro_torch.core.engine import SSOEngine
        from repro_torch.models.gnn.layers import get_gnn

        cfg, tr, dev = self.config, self.traffic, self.device
        t0 = time.perf_counter()
        self.inputs = inp = harness.make_inputs(cfg, tr, self.seed, dev)
        self.timings["inputs_s"] = time.perf_counter() - t0
        self.plan, self.parts = harness.program_graph(
            cfg, tr, inp, dev, self.timings)
        perm = self.plan.ro.perm
        self.y = inp.y[perm]
        self.counters, self.storage, cache = harness.program_storage(tr)
        self.engine = SSOEngine(
            get_gnn(cfg["model"]), self.plan, cfg["dims"], self.storage,
            cache, self.counters, mode=tr["mode"],
            pipeline=harness.pipeline_config(tr), device=dev)
        t0 = time.perf_counter()
        self.engine.initialize(inp.x[perm])
        self.timings["initialize_s"] = time.perf_counter() - t0
        self.params = harness.program_params(cfg, inp, dev)
        self.opt = optim.adamw_init(self.params)
        p0 = {k: v.detach().clone() for k, v in self._leaves().items()}
        self.losses, self.grad1 = [], {}
        t0 = time.perf_counter()
        for t in range(tr["checked_steps"]):
            self.losses.append(self.step())
            if t == 0:
                b1 = self.optim["b1"]
                self.grad1 = {k: float(m.norm()) / (1 - b1)
                              for k, m in self.opt["m"].items()}
        self.timings["checked_steps_s"] = time.perf_counter() - t0
        self.change = {k: float((v.detach() - p0[k]).norm())
                       for k, v in self._leaves().items()}

    def _leaves(self):
        return {f"{i}.{k}": p for i, layer in enumerate(self.params)
                for k, p in layer.named_parameters()}

    def step(self) -> float:
        import torch

        from repro_torch import optim

        loss, grads = self.engine.run_epoch(self.params, self.y)
        self.params, self.opt = optim.adamw_update(
            grads, self.params, self.opt, **self.optim)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return float(loss)

    def close(self) -> None:
        try:
            self.engine.close()
        finally:
            self.storage.close()
        self.engine = self.storage = self.params = self.opt = None

    def readings(self) -> dict:
        return {"losses": self.losses, "grad1": self.grad1,
                "change": self.change}

    def reference(self, **precision) -> dict:
        return reference.train_readings(
            self.config, self.inputs, self.optim,
            self.traffic["checked_steps"], self.device, **precision)

    def check(self) -> dict:
        return compare.train_numbers(self.readings(), self.reference())
