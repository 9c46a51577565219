"""Inference launcher: ``python -m repro_torch.launch.infer --arch <id> [...]``.

The port's counterpart of ``python -m repro.launch.infer``: runs
storage-offloaded layer-wise inference (repro_torch/infer/) for a GNN arch on
a small synthetic graph on the CUDA card, checks the pipelined engine
against the serial one (bit-identical embedding table) and the served
lookups against a dense whole-graph forward, then reports the
EmbeddingServer's hit/latency stats.

``--telemetry-port PORT`` serves live Prometheus metrics (``GET
/metrics``, :class:`~repro_torch.obs.live.TelemetryServer`; 0 picks a free
port) over the pipelined run and its serving lookups; ``--ledger [PATH]``
appends one ``infer_smoke`` record (:mod:`repro_torch.obs.ledger`,
``backend`` the device type) to that JSONL ledger. ``--device cpu`` runs
on the CPU.

Exit status 0 iff every check passes.
"""
from __future__ import annotations

import argparse
import functools
import sys
from typing import Optional, Sequence

# the GNN arch ids of the reference's config registry and the model family
# each one names (the configs package is not ported); every family is in
# ``GNN_REGISTRY`` (``gat`` and ``gin`` have no arch id: the smokes below
# take a family name)
GNN_ARCHS = {
    "gcn-cora": "gcn",
    "gcn-igbm-3l": "gcn",
    "graphsage-reddit": "sage",
    "pna": "pna",
    "graphcast": "graphcast",
}


@functools.lru_cache(maxsize=1)
def _smoke_graph(n_nodes: int, avg_degree: int, n_parts: int, device):
    """The smoke's graph and partition plan: ``add_self_loops`` of a seeded
    Kronecker graph, switching-aware partitions, GCN edge weights. The last
    one is kept, so a caller that runs several smokes on one graph (one per
    kernel mode) builds it once."""
    from repro_torch.core.plan import build_plan
    from repro_torch.graph import (
        gcn_norm_coeffs, kronecker_graph, switching_aware_partition,
    )
    from repro_torch.graph.csr import add_self_loops

    g = add_self_loops(kronecker_graph(n_nodes, avg_degree, seed=0))
    res = switching_aware_partition(g, n_parts, max_iters=8, seed=0)
    plan = build_plan(g, res.parts, n_parts, edge_weight=gcn_norm_coeffs(g),
                      device=device)
    return g, plan


def _infer_smoke(
    model: str,
    depth: int,
    cache_mb: int = 4,
    serve_cache_kb: int = 256,
    queries: int = 8,
    batch: int = 64,
    fp16: bool = False,
    gather_workers: int = 1,
    trace: Optional[str] = None,
    dims: Optional[Sequence[int]] = None,
    n_nodes: int = 2000,
    n_parts: int = 6,
    avg_degree: int = 7,
    kernels: str = "auto",
    dense_check: bool = True,
    device=None,
    telemetry_port: Optional[int] = None,
    ledger: Optional[str] = None,
) -> dict:
    """Drive OffloadedInference (serial + pipelined) and the
    EmbeddingServer for a GNN arch on ``device`` (the CUDA card unless
    ``device="cpu"``); returns the check/stat dict. ``dims`` defaults to
    ``[24, 32, 8]`` (input, hidden..., output).
    ``telemetry_port`` serves live Prometheus metrics over the run at
    ``depth`` (its counters, the serve-side gauges included) while it and
    its lookups run; ``ledger`` appends a ``run_kind="infer_smoke"`` record
    of that run to that JSONL ledger.

    Served rows are checked against the table on storage (bitwise) and,
    with ``dense_check``, against a dense whole-graph forward (off where
    the whole graph's messages do not fit on the device). ``runs`` maps
    each depth to its final table, ``Counters``, wall seconds and peak
    device bytes."""
    import tempfile
    import time

    import numpy as np
    import torch

    from repro_torch.core.cache import HostCache
    from repro_torch.core.counters import Counters
    from repro_torch.core.storage import StorageTier
    from repro_torch.device import resolve_device
    from repro_torch.graph.synthetic import random_features
    from repro_torch.infer import EmbeddingServer, OffloadedInference
    from repro_torch.models.gnn.layers import (
        full_graph_forward, full_graph_topo, get_gnn,
    )
    from repro_torch.runtime import PipelineConfig

    device = resolve_device(device)
    on_card = device.type == "cuda"
    dims = list(dims) if dims is not None else [24, 32, 8]
    g, plan = _smoke_graph(n_nodes, avg_degree, n_parts, device)
    spec = get_gnn(model)
    params = spec.init(torch.Generator().manual_seed(0), dims[0], dims[1],
                       dims[-1], len(dims) - 1, device=device)
    X = random_features(g.n_nodes, dims[0], 0)[plan.ro.perm]
    store_dtype = np.float16 if fp16 else None
    # the kernel modes stage whole partition blocks: one stack can hold
    # every block of the widest layer, so let the pool park a few of those
    stack_bytes = (g.n_nodes + 1) * max(dims) * 4
    pool_max_bytes = max(PipelineConfig.pool_max_bytes, 4 * stack_bytes)

    runs = {}
    stats = {}
    for d in sorted({0, depth}):
        c = Counters()
        st_ = StorageTier(tempfile.mkdtemp(), counters=c)
        cache = HostCache(cache_mb << 20, st_, c)
        inf = OffloadedInference(
            spec, plan, dims, st_, cache, c,
            pipeline=PipelineConfig(
                depth=d, gather_workers=gather_workers, kernels=kernels,
                pool_max_bytes=pool_max_bytes,
                # trace the requested depth only (the other iteration is
                # the serial equivalence check)
                trace=trace if d == depth else None,
            ),
            store_dtype=store_dtype,
            device=device,
        )
        server = None
        if telemetry_port is not None and d == depth:
            from repro_torch.obs.live import TelemetryServer
            server = TelemetryServer(c, port=telemetry_port).start()
        inf.initialize(X)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        name = inf.run(params)
        if on_card:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        table = st_.read_rows(name, 0, g.n_nodes)
        runs[d] = dict(
            table=table, counters=c, wall_s=wall,
            peak_device_bytes=(torch.cuda.max_memory_allocated(device)
                               if on_card else 0),
        )
        inf.close()
        if d != depth:
            st_.close()
            continue
        # serve the pipelined run's table (sharing the run's counters, so
        # lookups land in the same metrics registry and — when tracing —
        # the same timeline)
        srv = EmbeddingServer(st_, name, plan.ro, serve_cache_kb << 10,
                              counters=c)
        ref = None
        if dense_check:
            rg = plan.ro.graph
            topo = full_graph_topo(
                rg.indptr, rg.indices, rg.n_nodes, plan.edge_weight,
                device=device,
            )
            with torch.no_grad():
                ref = full_graph_forward(spec, params, X, topo).cpu().numpy()
        rng = np.random.default_rng(0)
        tol = 5e-2 if fp16 else 1e-3
        table_ok = dense_ok = True
        for _ in range(queries):
            ids = rng.integers(0, g.n_nodes, batch)
            got = srv.lookup(ids)
            rows = plan.ro.inv_perm[ids]
            table_ok &= bool(np.array_equal(got, table[rows]))
            if ref is not None:
                dense_ok &= bool(np.allclose(got.astype(np.float32),
                                             ref[rows], rtol=tol, atol=tol))
        stats = srv.stats()
        stats["serve_matches_table"] = table_ok
        if dense_check:
            stats["serve_matches_dense"] = dense_ok
        srv.close()
        if trace and c.tracer.enabled:
            # re-export: the engine's close() wrote the inference timeline
            # before the serving lookups above recorded their spans
            c.tracer.export_chrome_trace(trace)
        if server is not None:
            server.stop()
        st_.close()

    if ledger:
        from repro_torch.obs.ledger import RunLedger, make_record
        RunLedger(ledger).append(make_record(
            "infer_smoke",
            dict(model=model, depth=depth, cache_mb=cache_mb,
                 serve_cache_kb=serve_cache_kb, queries=queries,
                 batch=batch, fp16=fp16, gather_workers=gather_workers,
                 dims=dims, n_nodes=n_nodes, n_parts=n_parts,
                 avg_degree=avg_degree, kernels=kernels),
            dict(wall_s=runs[depth]["wall_s"],
                 hit_rate=float(stats.get("hit_rate", 0.0)),
                 p99_ms=float(stats.get("p99_ms", 0.0))),
            counters=runs[depth]["counters"],
            watch={"wall_s": "lower", "p99_ms": "lower"},
            backend=device.type,
        ))

    tables = [r["table"] for r in runs.values()]
    return dict(
        finite=all(bool(np.all(np.isfinite(t.astype(np.float32))))
                   for t in tables),
        pipeline_matches_serial=bool(np.array_equal(tables[0], tables[-1])),
        depth=depth,
        fp16=fp16,
        kernels=kernels,
        wall_s=runs[depth]["wall_s"],
        **stats,
        runs=runs,
    )


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="a GNN arch id (e.g. gcn-cora); the model family "
                         "is recovered from the config naming convention")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="async pipeline lookahead (0 = serial engine)")
    ap.add_argument("--gather-workers", type=int, default=1)
    ap.add_argument("--cache-mb", type=int, default=4,
                    help="host-cache budget for the inference engine")
    ap.add_argument("--serve-cache-kb", type=int, default=256,
                    help="dedicated host-cache budget for the "
                         "EmbeddingServer")
    ap.add_argument("--queries", type=int, default=8,
                    help="lookup batches to issue against the server")
    ap.add_argument("--batch", type=int, default=64,
                    help="node ids per lookup batch")
    ap.add_argument("--fp16", action="store_true",
                    help="store activations/embeddings in float16 on "
                         "storage (compute stays float32)")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="write a Chrome/Perfetto trace_event timeline of "
                         "the inference + serving run (ui.perfetto.dev)")
    ap.add_argument("--telemetry-port", type=int, default=None,
                    metavar="PORT",
                    help="serve live Prometheus metrics (GET /metrics) for "
                         "the duration of the run (0 = ephemeral)")
    ap.add_argument("--ledger", nargs="?", const="RUNS/ledger.jsonl",
                    default=None, metavar="PATH",
                    help="append a run record to this JSONL ledger "
                         "(repro_torch.obs.ledger)")
    ap.add_argument("--device", default=None,
                    help="the device (default: the CUDA card; 'cpu' for a "
                         "CPU run)")
    args = ap.parse_args(argv)
    if args.trace:
        import logging
        logging.basicConfig(level=logging.INFO,
                            format="%(name)s %(message)s")

    if args.arch not in GNN_ARCHS:
        print(f"{args.arch}: inference requires a GNN arch "
              f"(one of {sorted(GNN_ARCHS)})")
        sys.exit(2)
    model = GNN_ARCHS[args.arch]
    r = _infer_smoke(
        model, args.pipeline_depth, cache_mb=args.cache_mb,
        serve_cache_kb=args.serve_cache_kb, queries=args.queries,
        batch=args.batch, fp16=args.fp16,
        gather_workers=args.gather_workers, trace=args.trace,
        device=args.device, telemetry_port=args.telemetry_port,
        ledger=args.ledger,
    )
    r.pop("runs")
    print(f"{args.arch} infer smoke: {r}")
    if args.trace:
        print(f"trace written to {args.trace}")
    ok = (
        r.get("finite")
        and r.get("pipeline_matches_serial", True)
        and r.get("serve_matches_table", True)
        and r.get("serve_matches_dense", True)
    )
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
