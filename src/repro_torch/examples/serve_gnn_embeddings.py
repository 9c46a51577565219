"""End-to-end demo: train → infer → serve GNN embeddings, all beyond
host-cache capacity — the port of ``examples/serve_gnn_embeddings.py``.

The full deployment story on one box: the SSO engine trains a GCN with
activations offloaded to the storage tier, storage-offloaded layer-wise
inference (repro_torch/infer/) turns the trained model into a final-layer
embedding table on the SAME tier (truncating each consumed activation file
as it goes), and an EmbeddingServer answers skewed original-id query
traffic from that table through a dedicated host cache, batching misses
into vectored storage reads.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_gnn_embeddings [--smoke]

On the CUDA card unless ``--device cpu``. Returns (and exits with) 0 iff
the ``--smoke`` checks pass.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
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
from repro_torch.infer import EmbeddingServer, OffloadedInference, zipf_batches
from repro_torch.models.gnn.layers import (
    full_graph_forward, full_graph_topo, get_gnn,
)
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.runtime import PipelineConfig


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=20000)
    ap.add_argument("--parts", type=int, default=12)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--layers", type=int, default=3)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--cache-mb", type=int, default=8)
    ap.add_argument("--pipeline-depth", type=int, default=2)
    ap.add_argument("--serve-cache-kb", type=int, default=512)
    ap.add_argument("--queries", type=int, default=200,
                    help="lookup batches of query traffic")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--zipf", type=float, default=1.1)
    ap.add_argument("--fp16", action="store_true",
                    help="serve a float16 on-storage embedding table")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes + verification against a dense "
                         "forward (the CI gate)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.nodes, args.parts, args.layers = 2000, 6, 2
        args.hidden, args.epochs, args.queries = 32, 2, 40
        args.cache_mb = 1
    device = resolve_device(args.device)

    # ---- build graph + plan
    g = add_self_loops(kronecker_graph(args.nodes, 10, seed=0))
    res = switching_aware_partition(g, args.parts, max_iters=20, seed=0)
    plan = build_plan(g, res.parts, args.parts,
                      edge_weight=gcn_norm_coeffs(g), device=device)
    H = args.hidden
    dims = [H] + [H] * (args.layers - 1) + [args.classes]
    X = random_features(g.n_nodes, H, 0)[plan.ro.perm]
    Y = random_labels(g.n_nodes, args.classes, 0)[plan.ro.perm]
    spec = get_gnn("gcn")
    params = spec.init(torch.Generator().manual_seed(0), H, H, args.classes,
                       args.layers, device=device)
    opt = adamw_init(params)

    c = Counters()
    storage = StorageTier(tempfile.mkdtemp(prefix="grinnder_serve_"),
                          counters=c)
    try:
        # ---- 1. train (offloaded)
        cache = HostCache(args.cache_mb << 20, storage, c)
        engine = SSOEngine(spec, plan, dims, storage, cache, c,
                           mode="regather",
                           pipeline=PipelineConfig(depth=args.pipeline_depth),
                           device=device)
        try:
            engine.initialize(X)
            for epoch in range(args.epochs):
                loss, grads = engine.run_epoch(params, Y)
                params, opt = adamw_update(grads, params, opt, lr=5e-3)
                print(f"train epoch {epoch} loss {loss:.5f}")
        finally:
            engine.close()
        train_peak = c.storage_peak_alloc_bytes

        # ---- 2. infer (same storage tier, fresh cache, trained params)
        t0 = time.perf_counter()
        inf_cache = HostCache(args.cache_mb << 20, storage, c)
        inf = OffloadedInference(
            spec, plan, dims, storage, inf_cache, c,
            pipeline=PipelineConfig(depth=args.pipeline_depth),
            store_dtype=np.float16 if args.fp16 else None,
            keep_input=False,
            device=device,
        )
        try:
            inf.initialize(X)
            table = inf.run(params)
        finally:
            inf.close()
        t_infer = time.perf_counter() - t0
        print(f"inference: table '{table}' "
              f"({g.n_nodes}x{dims[-1]} {storage.dtype(table)}) "
              f"in {t_infer:.2f}s; storage now "
              f"{storage.allocated_bytes/1e6:.1f}MB "
              f"(train peak {train_peak/1e6:.1f}MB)")

        # ---- 3. serve
        srv = EmbeddingServer(storage, table, plan.ro,
                              args.serve_cache_kb << 10, counters=c)
        try:
            rng = np.random.default_rng(1)
            traffic = zipf_batches(rng, g.n_nodes, args.batch, args.queries,
                                   args.zipf)
            t0 = time.perf_counter()
            for ids in traffic:
                srv.lookup(ids)
            wall = time.perf_counter() - t0
            s = srv.stats()
            qps = args.queries / wall if wall > 0 else float("inf")
            print(f"served {s['rows_served']} rows in {args.queries} "
                  f"batches: {qps:.0f} batches/s "
                  f"({s['rows_served']/wall:.0f} rows/s), "
                  f"hit_rate={s['hit_rate']:.3f} "
                  f"p50={s['p50_ms']:.3f}ms p99={s['p99_ms']:.3f}ms")

            ok = True
            if args.smoke:
                # every served embedding must match a dense whole-graph
                # forward
                rg = plan.ro.graph
                topo = full_graph_topo(rg.indptr, rg.indices, rg.n_nodes,
                                       plan.edge_weight, device=device)
                with torch.no_grad():
                    ref = full_graph_forward(spec, params, X,
                                             topo).cpu().numpy()
                ids = rng.integers(0, g.n_nodes, 256)
                got = srv.lookup(ids).astype(np.float32)
                want = ref[plan.ro.inv_perm[ids]]
                tol = 5e-2 if args.fp16 else 1e-3
                ok = bool(np.allclose(got, want, rtol=tol, atol=tol))
                print(f"smoke verification vs dense forward: "
                      f"{'OK' if ok else 'MISMATCH'} "
                      f"(max abs err {np.abs(got - want).max():.2e})")
                if s["hits"] <= 0:
                    print("smoke FAIL: no cache hits under zipf traffic")
                    ok = False
        finally:
            srv.close()
    finally:
        storage.close()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
