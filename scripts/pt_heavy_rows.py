#!/usr/bin/env python3
"""The heavy-row thresholds of ``gather_aggregate`` and ``edge_softmax`` on
the card, at ``chip_smoke.py``'s main-path shapes.

    PYTHONPATH=src python scripts/pt_heavy_rows.py [--thresholds 64,256,1024]

Builds ``chip_smoke.py``'s 262,144-node graph and its largest layer-0 unit
(stack 262,145 rows, 1,955,606 edges into 32,768 rows), prints the unit's
in-degree distribution, then for each threshold T (a row with more than T
edges is heavy) times, with ``chip_smoke.time_ms`` (5 calls, CUDA events)
in the order a b ... b a, and with ``chip_smoke.queued_ms`` (the median
device time of 20 launches queued behind a sleep, a b b a):
``gather_aggregate`` at D 1,024 and 256, each output bitwise equal to the
first threshold's (the split changes no bit); ``edge_softmax`` at H 4,
within ``(deg + 4) * 2^-23`` relative of its plain version; and the row
plan alone (``gather_scatter.ops.row_plan``, the card's planner both
kernels launch first). Then, at the committed thresholds, each call's
device time per kernel (``torch.profiler``). CSR ``torch.sparse.mm`` and the bounds
are printed beside them. One JSON object a line per threshold. Needs one
CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--thresholds", default="64,128,256,512,1024,1000000000")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pt_heavy_rows: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels.edge_softmax import ops as es_ops
    from repro_torch.kernels.edge_softmax import ref as es_ref
    from repro_torch.kernels.gather_scatter import ops as gs_ops

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    thresholds = [int(t) for t in args.thresholds.split(",")]
    committed = gs_ops.HEAVY_EDGES, es_ops.HEAVY_EDGES
    plan = chip_smoke.build_full_width(dev)
    _, _, total, erows, dst, w, n_dst = chip_smoke.main_unit(plan, dev)
    del plan
    E = dst.shape[0]
    deg = torch.bincount(dst.long(), minlength=n_dst)
    deg_np = deg.cpu().numpy()
    print(json.dumps(dict(
        edges=E, rows=n_dst, max_degree=int(deg_np.max()),
        mean_degree=E / n_dst,
        rows_over={t: int((deg_np > t).sum()) for t in thresholds},
        edges_in_rows_over={t: int(deg_np[deg_np > t].sum())
                            for t in thresholds})), flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    tables = {}
    for d in chip_smoke.DIMS[:2]:
        t = torch.randn((total + 1, d), generator=gen, device=dev)
        t[total] = 0
        tables[d] = t
    scores = torch.randn((E, chip_smoke.GAT_HEADS), generator=gen, device=dev)
    plain = es_ref.edge_softmax_ref(scores, dst, n_dst)
    tol = (deg.float().index_select(0, dst.long())[:, None] + 4) \
        * 2.0 ** -23 * plain.abs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "CSR is beta"
        A = torch.sparse_coo_tensor(
            torch.stack([dst.long(), erows.long()]), w,
            size=(n_dst, total + 1), check_invariants=True,
        ).coalesce().to_sparse_csr()
    uniq = int(torch.unique(erows).numel())
    library = {d: chip_smoke.time_ms(lambda: torch.sparse.mm(A, t))
               for d, t in tables.items()}
    bounds = {d: chip_smoke.bound(uniq * d * 4 + 12 * E + n_dst * d * 4,
                                  2.0 * E * d)[0] for d in tables}
    H = chip_smoke.GAT_HEADS
    es_bound = chip_smoke.bound(2 * E * H * 4 + 4 * E, 4.0 * E * H)[0]

    first = {}
    rows = {t: dict(threshold=t, gather_aggregate_ms={d: [] for d in tables},
                    edge_softmax_ms=[], plan_ms=[], queued_ms={})
            for t in thresholds}
    for t in thresholds + thresholds[::-1]:
        gs_ops.HEAVY_EDGES = es_ops.HEAVY_EDGES = t
        r = rows[t]
        for d, tab in tables.items():
            out = gs_ops.gather_aggregate(tab, erows, dst, w, n_dst)
            same = torch.equal(out, first.setdefault(d, out))
            r["bitwise_equal_to_first"] = r.get("bitwise_equal_to_first",
                                                True) and same
            r["gather_aggregate_ms"][d].append(chip_smoke.time_ms(
                lambda: gs_ops.gather_aggregate(tab, erows, dst, w, n_dst)))
        got = es_ops.edge_softmax(scores, dst, n_dst)
        r["edge_softmax_within_bound"] = bool(
            torch.all((got - plain).abs() <= tol))
        r["edge_softmax_ms"].append(chip_smoke.time_ms(
            lambda: es_ops.edge_softmax(scores, dst, n_dst)))
        r["plan_ms"].append(chip_smoke.time_ms(
            lambda: gs_ops.row_plan(dst, n_dst, t)))
        if not r["queued_ms"]:
            r["queued_ms"] = chip_smoke.queued_ms({
                **{f"gather_aggregate D {d}":
                   (lambda tab=tab: gs_ops.gather_aggregate(tab, erows, dst,
                                                            w, n_dst))
                   for d, tab in tables.items()},
                "edge_softmax": lambda: es_ops.edge_softmax(scores, dst,
                                                            n_dst),
                "row_plan": lambda: gs_ops.row_plan(dst, n_dst, t)},
                launches=20)
    for t in thresholds:
        print(json.dumps(dict(**rows[t], library_csr_ms=library,
                              gather_aggregate_bound_ms=bounds,
                              edge_softmax_bound_ms=es_bound)), flush=True)
    # where the time goes at the committed thresholds: device time per
    # kernel of one call each (torch.profiler, CUPTI)
    gs_ops.HEAVY_EDGES, es_ops.HEAVY_EDGES = committed
    calls = {f"gather_aggregate D {d}":
             (lambda tab=tab: gs_ops.gather_aggregate(tab, erows, dst, w,
                                                      n_dst))
             for d, tab in tables.items()}
    calls["edge_softmax"] = lambda: es_ops.edge_softmax(scores, dst, n_dst)
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        print(json.dumps(dict(call=name, threshold=committed, kernels_us={
            e.key: round(e.device_time_total, 1)
            for e in prof.key_averages() if e.device_time_total > 0})),
            flush=True)
    ok = all(r["bitwise_equal_to_first"] and r["edge_softmax_within_bound"]
             for r in rows.values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
