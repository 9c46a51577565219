"""Quickstart: storage-offloaded full-graph GNN training — the port of
``examples/quickstart.py``.

Builds a power-law synthetic graph, partitions it with switching-aware
partitioning, trains a 3-layer GCN with the GriNNder regather engine, and
checks that the loss curve equals in-memory autograd on the whole graph.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart

On the CUDA card unless ``--device cpu``; ``--nodes``, ``--parts`` and
``--epochs`` cut the run.
"""
from __future__ import annotations

import argparse
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch.core.cache import HostCache
from repro_torch.core.counters import Counters
from repro_torch.core.engine import SSOEngine
from repro_torch.core.plan import build_plan
from repro_torch.core.storage import StorageTier
from repro_torch.device import resolve_device
from repro_torch.graph import (
    gcn_norm_coeffs, kronecker_graph, switching_aware_partition,
)
from repro_torch.graph.csr import add_self_loops
from repro_torch.graph.synthetic import random_features, random_labels
from repro_torch.models.gnn.layers import (
    full_graph_loss, full_graph_topo, get_gnn,
)
from repro_torch.optim.adamw import sgd_update

# the loss gap to in-memory autograd that counts as equal (float32
# reassociation across partitions)
MATCH_TOL = 1e-4


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1. graph + partitioning (the paper's lightweight partitioner)
    g = add_self_loops(kronecker_graph(args.nodes, 10, seed=0))
    res = switching_aware_partition(g, n_parts=args.parts, max_iters=20)
    plan = build_plan(g, res.parts, args.parts, edge_weight=gcn_norm_coeffs(g),
                      device=device)
    print(f"graph: {g.n_nodes} nodes / {g.n_edges} edges, "
          f"alpha={plan.alpha:.2f}, partitioner peak mem "
          f"{res.total_bytes/1e6:.1f}MB")

    # 2. data + model
    X = random_features(g.n_nodes, 64, 0)[plan.ro.perm]
    Y = random_labels(g.n_nodes, 10, 0)[plan.ro.perm]
    spec = get_gnn("gcn")
    dims = [64, 64, 64, 10]
    params = spec.init(torch.Generator().manual_seed(0), 64, 64, 10, 3,
                       device=device)

    # 3. the SSO engine: storage tier + partition-wise host cache
    c = Counters()
    storage = StorageTier(tempfile.mkdtemp(prefix="grinnder_"), counters=c)
    cache = HostCache(8 << 20, storage, c)  # 8 MB host budget
    engine = SSOEngine(spec, plan, dims, storage, cache, c, mode="regather",
                       device=device)
    losses, ref_losses = [], []
    try:
        engine.initialize(X)

        # 4. train offloaded; compare with the in-memory oracle
        rg = plan.ro.graph
        topo = full_graph_topo(rg.indptr, rg.indices, rg.n_nodes,
                               plan.edge_weight, device=device)
        params_ref = params
        # SGD so float-reassociation noise (~1e-6) isn't sign-amplified by
        # Adam
        for epoch in range(args.epochs):
            loss, grads = engine.run_epoch(params, Y)
            params = sgd_update(grads, params, lr=5e-2)
            ref_loss = full_graph_loss(spec, params_ref, X, topo, Y)
            ref_grads = torch.autograd.grad(ref_loss,
                                            list(params_ref.parameters()))
            params_ref = sgd_update(ref_grads, params_ref, lr=5e-2)
            losses.append(loss)
            ref_losses.append(float(ref_loss.detach()))
            print(f"epoch {epoch}: offloaded={loss:.5f} "
                  f"in-memory={ref_losses[-1]:.5f} "
                  f"(match: {abs(loss - ref_losses[-1]) < MATCH_TOL})")
    finally:
        engine.close()
        storage.close()

    seen = c.cache_hits + c.cache_misses
    print(f"\nI/O: storage read {c.storage_read_bytes/1e6:.1f}MB / write "
          f"{c.storage_write_bytes/1e6:.1f}MB, host<->device "
          f"{(c.h2d_bytes+c.d2h_bytes)/1e6:.1f}MB, cache hit-rate "
          f"{c.cache_hits/max(seen, 1):.2%}, "
          f"peak host {c.cache_peak_bytes/1e6:.1f}MB")
    return dict(
        losses=losses, ref_losses=ref_losses,
        match=all(abs(a - b) < MATCH_TOL for a, b in zip(losses, ref_losses)),
    )


if __name__ == "__main__":
    main()
