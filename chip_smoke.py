#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch/``).

    python3 chip_smoke.py            # one CUDA card, nvcc under /usr/local/cuda

Builds the CUDA kernels from the sources in this checkout, then:

- Phase A: each kernel against its plain PyTorch version at the shapes the
  main path gives it (the largest layer-0 unit of phase C's plan; for
  ``scatter_add`` phase D's largest grad write-back that is not one
  contiguous run): ``gather_rows`` bitwise; ``gather_aggregate`` bitwise
  against the numpy FMA oracle at small shapes and, at the main-path shape,
  within ``(deg_row + 1) * 2^-23 * sum_e |w_e x_e|`` of the plain version;
  ``scatter_add`` bitwise against the ``np.add.at`` oracle at small shapes
  (duplicates, D = 7, one row, an untouched tail) and against its plain
  version at the main-path shape, and deterministic on a rerun. Prints
  kernel, plain, bound and library (``index_select`` / CSR
  ``torch.sparse.mm`` / ``index_add_``) times; the port never calls the
  library ops.
- Phase B: the port's ``launch.infer`` default smoke on the card (2000
  nodes, dims [24, 32, 8]): finite, pipelined == serial, served == dense.
- Phase C, serving at full width: ``gcn-igbm-3l`` widths
  [1024, 256, 256, 19] on a 262,144-node Kronecker graph (16
  switching-aware partitions, 512 MB host cache, so the 1.07 GB layer-0
  table is really offloaded), the launcher's ``_infer_smoke`` in modes
  reference, kernel and kernel-fused at pipeline depth 0 and 2. Checks
  kernel == reference and pipelined == serial bitwise, kernel-fused within
  1e-4 of reference, finite tables, server lookups equal to the table on
  storage, and each mode's own launch counts: none in reference, one
  ``gather_rows`` per unit and layer in kernel, one ``gather_aggregate`` per
  unit and layer in kernel-fused.
- Phase D, training at full width (the main path): the same graph, widths
  and cache, random labels over 19 classes; the launcher's ``_train_smoke``
  (one epoch — forward, loss, backward — and one AdamW update) in the three
  modes at depth 0 and 2. Checks finite loss and gradients, pipelined ==
  serial and kernel == reference bitwise (loss and every gradient),
  kernel-fused within 1e-4 (loss) and 5e-4 max-relative (gradients) of
  reference, and each mode's own launch counts, worked out from the plan:
  none in reference; ``gather_rows`` per unit in each forward and backward
  layer in kernel, and ``scatter_add`` per (layer 1..L-1, unit, source
  partition whose rows are not one contiguous run); ``gather_aggregate`` in
  the forward, ``gather_rows`` in the backward and the same ``scatter_add``
  count in kernel-fused.
- Phase E, small: the same widths on a 20,000-node graph, where a dense
  whole-graph autograd oracle fits: each mode's loss within 1e-4 and
  gradients within 5e-4 of the oracle; then a 3-epoch checkpointed
  ``run_epoch_loop`` that crashes in epoch 2 and a second loop that resumes
  from the epoch-2 checkpoint: its final parameters equal an uninterrupted
  run's bitwise.

Any failed check exits non-zero; no phase's failure is caught. TF32 is off
for matmuls and cuDNN (float32 means float32 here). The last line is the
JSON device record; the line before it the per-kernel JSON record.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12         # H100 SXM float32, outside the tensor cores
KERNEL_SOURCE = "src/repro_torch/kernels/gather_scatter/csrc/gather_scatter.cu"
REPLACES = {
    "gather_rows": "src/repro/kernels/gather_scatter/gather_scatter.py:50",
    "gather_aggregate": "src/repro/kernels/gather_scatter/gather_scatter.py:91",
    "scatter_add": "src/repro/kernels/gather_scatter/gather_scatter.py:141",
}
MODES = ("reference", "kernel", "kernel-fused")
# phase C: gcn-igbm-3l widths on a 262,144-node graph; a 512 MB host cache
# holds about half of the 1.07 GB layer-0 table
DIMS = [1024, 256, 256, 19]
N_NODES = 262144
AVG_DEGREE = 12
N_PARTS = 16
CACHE_MB = 512
# phase E: the same widths on a graph whose dense oracle fits the card
E_NODES = 20000
E_PARTS = 8
E_CACHE_MB = 64


def check(cond, what: str) -> None:
    if not cond:
        print(f"FAIL: {what}", flush=True)
        raise SystemExit(1)
    print(f"  ok: {what}", flush=True)


def rel_err(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30))


def time_ms(fn, iters: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events, after
    one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(nbytes: float, flops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# --------------------------------------------------------------- the graph
def build_full_width(dev):
    from repro_torch.launch.infer import _smoke_graph

    t0 = time.perf_counter()
    g, plan = _smoke_graph(N_NODES, AVG_DEGREE, N_PARTS, dev)
    u = max(plan.units, key=lambda u: (u.e_pad, u.n_req))
    print(f"graph: {g.n_nodes} nodes, {g.n_edges} edges, {N_PARTS} parts, "
          f"alpha {plan.alpha:.3f}, largest unit p={u.p} n_dst={u.n_dst} "
          f"n_req={u.n_req} r_pad={u.r_pad} n_edges={u.n_edges} "
          f"e_pad={u.e_pad}; built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return plan


def scatter_row_sets(plan):
    """Every (unit, source partition, local rows) of the backward's grad
    write-back whose rows are not one contiguous run — the ones the
    dispatcher sends to the ``scatter_add`` kernel (per layer 1..L-1)."""
    import numpy as np

    out = []
    for p in plan.schedule:
        u = plan.unit(p)
        ptr = u.req_part_ptr
        for q in u.req_parts:
            a0, _ = plan.ro.partition_slice(int(q))
            rows = u.req_global[ptr[q] : ptr[q + 1]] - a0
            n = rows.size
            contiguous = int(rows[-1]) - int(rows[0]) + 1 == n and (
                n == 1 or bool(np.all(np.diff(rows) == 1)))
            if not contiguous:
                out.append((u, int(q), rows))
    return out


# ----------------------------------------------------------------- phase A
def phase_a(plan, d_in: int, dev):
    import numpy as np
    import torch

    from repro_torch.kernels.gather_scatter import ops, ref
    from repro_torch.runtime.forward import unit_row_map

    print("phase A: kernels vs plain versions", flush=True)
    # the main path's shapes: the largest layer-0 unit's stack and row map
    # (exactly what the runner stages for that unit)
    u = max(plan.units, key=lambda u: (u.e_pad, u.n_req))
    idx_np, _, total = unit_row_map(plan, u)
    gen = torch.Generator(device=dev).manual_seed(0)
    stack = torch.randn((total + 1, d_in), generator=gen, device=dev)
    stack[total] = 0
    idx = torch.from_numpy(idx_np).to(dev)
    topo = u.topo
    e = topo.n_real_edges
    erows = idx.index_select(0, topo.src[:e])
    dst = topo.dst[:e]
    w = topo.edge_weight[:e]
    n_dst = topo.n_dst
    results = {}

    # ---- gather_rows: bitwise
    k = ops.gather_rows(stack, idx)
    p = ref.gather_rows_ref(stack, idx)
    torch.cuda.synchronize()
    check(torch.equal(k, p), f"gather_rows bitwise vs plain at stack "
          f"{tuple(stack.shape)}, rows {tuple(idx.shape)}")
    check(torch.equal(ops.gather_rows(stack, idx), k),
          "gather_rows deterministic (rerun bitwise)")
    R = idx.shape[0]
    uniq = int(torch.unique(idx).numel())
    nbytes = uniq * d_in * 4 + R * 4 + R * d_in * 4
    b_ms, b_by = bound(nbytes, 0.0)
    results["gather_rows"] = dict(
        max_abs_err=float((k - p).abs().max()),
        ms=time_ms(lambda: ops.gather_rows(stack, idx)),
        plain_ms=time_ms(lambda: ref.gather_rows_ref(stack, idx)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.index_select(stack, 0, idx)),
    )
    del k, p

    # ---- gather_aggregate: bitwise vs the FMA oracle at small shapes
    rng = np.random.default_rng(0)
    for (n, E, nd, D) in [(64, 500, 40, 128), (50, 300, 20, 24),
                          (40, 90, 12, 7), (6, 1, 3, 8)]:
        table = rng.standard_normal((n, D), dtype=np.float32)
        er = rng.integers(0, n, E).astype(np.int32)
        ds = np.sort(rng.integers(0, nd, E)).astype(np.int32)
        ws = rng.standard_normal(E, dtype=np.float32)
        got = ops.gather_aggregate(
            *(torch.from_numpy(a).to(dev) for a in (table, er, ds, ws)), nd)
        want = ref.gather_aggregate_ref_fma(table, er, ds, ws, nd)
        check(np.array_equal(got.cpu().numpy(), want),
              f"gather_aggregate bitwise vs FMA oracle (n={n} E={E} "
              f"n_dst={nd} D={D})")

    # ---- gather_aggregate at the main path's shape, vs the plain version
    k = ops.gather_aggregate(stack, erows, dst, w, n_dst)
    p = ref.gather_aggregate_ref(stack, erows, dst, w, n_dst)
    torch.cuda.synchronize()
    check(torch.equal(ops.gather_aggregate(stack, erows, dst, w, n_dst), k),
          "gather_aggregate deterministic (rerun bitwise)")
    check(torch.equal(ref.gather_aggregate_ref(stack, erows, dst, w, n_dst),
                      p),
          "plain segment sum deterministic on the card (rerun bitwise)")
    mag = ref.gather_aggregate_ref(stack.abs(), erows, dst, w.abs(), n_dst)
    deg = torch.bincount(dst.long(), minlength=n_dst).to(torch.float32)
    tol = (deg[:, None] + 1) * 2.0 ** -23 * mag
    err = (k - p).abs()
    check(bool(torch.all(err <= tol)),
          f"gather_aggregate within (deg+1)*2^-23*sum|w x| of plain at "
          f"E={dst.shape[0]} n_dst={n_dst} D={d_in} (max err "
          f"{float(err.max()):.3e}, max deg {int(deg.max())})")
    del mag, tol
    E = dst.shape[0]
    uniq = int(torch.unique(erows).numel())
    nbytes = uniq * d_in * 4 + 12 * E + n_dst * d_in * 4
    b_ms, b_by = bound(nbytes, 2.0 * E * d_in)
    # what a kernel that reads every edge's source row from memory must move
    edge_ms, _ = bound(E * d_in * 4 + 12 * E + n_dst * d_in * 4, 0.0)
    print(f"  gather_aggregate: {uniq} unique source rows of {E} edges; "
          f"bound with one row read per edge {edge_ms:.4f} ms", flush=True)
    # the yardstick's sparse matrix is built outside the timed region
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "CSR is beta"
        A = torch.sparse_coo_tensor(
            torch.stack([dst.long(), erows.long()]), w,
            size=(n_dst, stack.shape[0]), check_invariants=True,
        ).coalesce().to_sparse_csr()
    results["gather_aggregate"] = dict(
        max_abs_err=float(err.max()),
        ms=time_ms(lambda: ops.gather_aggregate(stack, erows, dst, w, n_dst)),
        plain_ms=time_ms(lambda: ref.gather_aggregate_ref(
            stack, erows, dst, w, n_dst)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.sparse.mm(A, stack)),
    )
    del k, p, err, A
    results["scatter_add"] = phase_a_scatter(plan, DIMS[1], dev)
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
              f"{r['library_ms']:.4f} ms, max abs err {r['max_abs_err']:.3e}",
              flush=True)
    del stack
    torch.cuda.empty_cache()
    return results


def phase_a_scatter(plan, d: int, dev) -> dict:
    """``scatter_add`` bitwise vs the numpy oracle at small shapes, then at
    phase D's largest non-contiguous grad write-back (the partition's grad
    buffer, width ``d``) bitwise vs its plain version, with times."""
    import numpy as np
    import torch

    from repro_torch.kernels.gather_scatter import ops, ref

    rng = np.random.default_rng(0)
    for (n, R, D, hi) in [(64, 200, 16, 64), (300, 77, 48, 300),
                          (40, 90, 7, 40), (10, 1, 7, 10), (50, 20, 8, 10),
                          (256, 500, 256, 256)]:
        base = rng.standard_normal((n, D), dtype=np.float32)
        rows = np.sort(rng.integers(0, hi, R)).astype(np.int32)
        vals = rng.standard_normal((R, D), dtype=np.float32)
        got = torch.tensor(base, device=dev)
        ops.scatter_add_(got, *(torch.from_numpy(a).to(dev)
                                for a in (rows, vals)))
        check(np.array_equal(got.cpu().numpy(),
                             ref.scatter_add_ref_np(base, rows, vals)),
              f"scatter_add bitwise vs np.add.at oracle (n={n} R={R} D={D}, "
              f"{R - len(np.unique(rows))} duplicates, rows < {hi})")

    u, q, rows_np = max(scatter_row_sets(plan), key=lambda t: t[2].size)
    a0, a1 = plan.ro.partition_slice(q)
    R = rows_np.size
    gen = torch.Generator(device=dev).manual_seed(1)
    base = torch.randn((a1 - a0, d), generator=gen, device=dev)
    values = torch.randn((R, d), generator=gen, device=dev)
    rows = torch.from_numpy(rows_np.astype(np.int32)).to(dev)
    k = ops.scatter_add_(base.clone(), rows, values)
    p = ref.scatter_add_ref(base.clone(), rows, values)
    torch.cuda.synchronize()
    check(torch.equal(k, p), f"scatter_add bitwise vs plain at base "
          f"{tuple(base.shape)}, {R} rows (unit p={u.p}, source partition "
          f"{q})")
    check(torch.equal(ops.scatter_add_(base.clone(), rows, values), k),
          "scatter_add deterministic (rerun bitwise)")
    U = int(torch.unique(rows).numel())
    b_ms, b_by = bound(R * d * 4 + 2 * U * d * 4 + 4 * R, float(R * d))
    kb, pb, lb = base.clone(), base.clone(), base.clone()
    out = dict(
        max_abs_err=float((k - p).abs().max()),
        ms=time_ms(lambda: ops.scatter_add_(kb, rows, values)),
        plain_ms=time_ms(lambda: ref.scatter_add_ref(pb, rows, values)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: lb.index_add_(0, rows, values)),
    )
    del k, p, kb, pb, lb, base, values
    return out


# ----------------------------------------------------------------- phase B
def phase_b(dev):
    from repro_torch.launch.infer import _infer_smoke

    print("phase B: launch.infer default smoke on the card", flush=True)
    r = _infer_smoke("gcn", 2, device=dev)
    r.pop("runs")
    print(f"  {r}", flush=True)
    check(r["finite"], "phase B table finite")
    check(r["pipeline_matches_serial"], "phase B pipelined == serial (bitwise)")
    check(r["serve_matches_table"], "phase B served == table on storage")
    check(r["serve_matches_dense"], "phase B served == dense forward")


# ----------------------------------------------------------------- phase C
def phase_c(plan, dev):
    import numpy as np

    from repro_torch.kernels.gather_scatter import ops
    from repro_torch.launch.infer import _infer_smoke

    print(f"phase C: offloaded inference at full width {DIMS}, "
          f"{CACHE_MB} MB host cache", flush=True)
    # one launch per unit and layer in each of the two runs (depth 0, 2)
    per_path = 2 * (len(DIMS) - 1) * sum(
        1 for p in plan.schedule if plan.unit(p).n_edges > 0)
    expect = {
        "reference": {"gather_rows": 0, "gather_aggregate": 0,
                      "scatter_add": 0},
        "kernel": {"gather_rows": per_path, "gather_aggregate": 0,
                   "scatter_add": 0},
        "kernel-fused": {"gather_rows": 0, "gather_aggregate": per_path,
                         "scatter_add": 0},
    }
    tables = {}
    launches = {}
    for mode in MODES:
        ops.reset_launches()      # this path's launches start here
        r = _infer_smoke(
            "gcn", 2, cache_mb=CACHE_MB, serve_cache_kb=4096, queries=16,
            batch=256, dims=DIMS, n_nodes=N_NODES, n_parts=N_PARTS,
            avg_degree=AVG_DEGREE, kernels=mode, dense_check=False,
            device=dev,
        )
        launches[mode] = dict(ops.LAUNCHES)
        for depth, run in r["runs"].items():
            c = run["counters"]
            busy = {k: round(v, 3) for k, v in c.stage_busy_seconds.items()}
            stall = {k: round(v, 3) for k, v in c.stage_stall_seconds.items()}
            phases = {k: round(v, 3) for k, v in c.phase_seconds.items()}
            print(f"  {mode} depth {depth}: wall {run['wall_s']:.3f} s, peak "
                  f"device {run['peak_device_bytes'] / 1e9:.2f} GB, storage "
                  f"read {c.storage_read_bytes / 1e9:.2f} GB, h2d "
                  f"{c.h2d_bytes / 1e9:.2f} GB, cache hits/misses "
                  f"{c.cache_hits}/{c.cache_misses}", flush=True)
            print(f"    busy {busy}", flush=True)
            print(f"    stall {stall}", flush=True)
            print(f"    phases {phases}", flush=True)
        print(f"  {mode} launches: {launches[mode]}", flush=True)
        check(r["finite"], f"{mode}: tables finite")
        check(r["pipeline_matches_serial"],
              f"{mode}: pipelined == serial (bitwise)")
        check(r["serve_matches_table"],
              f"{mode}: server lookups == table rows on storage (bitwise, "
              f"hit rate {r['hit_rate']:.3f}, p99 {r['p99_ms']:.3f} ms)")
        check(launches[mode] == expect[mode],
              f"{mode}: launches {launches[mode]} == {expect[mode]}")
        tables[mode] = r["runs"][0]["table"]
        del r
    check(np.array_equal(tables["kernel"], tables["reference"]),
          "kernel == reference (bitwise)")
    fe = rel_err(tables["reference"], tables["kernel-fused"])
    check(fe <= 1e-4, f"kernel-fused within 1e-4 of reference (rel {fe:.3e})")
    return launches


# ----------------------------------------------------------------- phase D
def print_run(label: str, run: dict) -> None:
    c = run["counters"]
    busy = {k: round(v, 3) for k, v in c.stage_busy_seconds.items()}
    stall = {k: round(v, 3) for k, v in c.stage_stall_seconds.items()}
    phases = {k: round(v, 3) for k, v in c.phase_seconds.items()}
    walls = ", ".join(f"{w:.3f}" for w in run["wall_s"])
    print(f"  {label}: wall per epoch [{walls}] s, peak device "
          f"{run['peak_device_bytes'] / 1e9:.2f} GB, storage read "
          f"{c.storage_read_bytes / 1e9:.2f} GB write "
          f"{c.storage_write_bytes / 1e9:.2f} GB, h2d {c.h2d_bytes / 1e9:.2f} "
          f"GB, d2h {c.d2h_bytes / 1e9:.2f} GB, cache hits/misses "
          f"{c.cache_hits}/{c.cache_misses}", flush=True)
    print(f"    busy {busy}", flush=True)
    print(f"    stall {stall}", flush=True)
    print(f"    phases {phases}", flush=True)


def grads_rel_err(want, got) -> float:
    return max(rel_err(w[k].cpu().numpy(), g[k].cpu().numpy())
               for w, g in zip(want, got) for k in w)


def phase_d(plan, dev):
    import torch

    from repro_torch.kernels.gather_scatter import ops
    from repro_torch.launch.train import _train_smoke

    print(f"phase D: offloaded training at full width {DIMS}, "
          f"{CACHE_MB} MB host cache, one epoch + AdamW", flush=True)
    L = len(DIMS) - 1
    units = len(plan.schedule)
    fused_units = sum(1 for p in plan.schedule if plan.unit(p).n_edges > 0)
    # two runs (depth 0 and 2); the scatter kernel runs per (layer 1..L-1,
    # unit, source partition whose rows are not one contiguous run)
    scatters = 2 * (L - 1) * len(scatter_row_sets(plan))
    expect = {
        "reference": {"gather_rows": 0, "gather_aggregate": 0,
                      "scatter_add": 0},
        "kernel": {"gather_rows": 2 * 2 * L * units, "gather_aggregate": 0,
                   "scatter_add": scatters},
        "kernel-fused": {"gather_rows": 2 * L * units,
                         "gather_aggregate": 2 * L * fused_units,
                         "scatter_add": scatters},
    }
    runs = {}
    launches = {}
    for mode in MODES:
        ops.reset_launches()      # this path's launches start here
        r = _train_smoke(
            "gcn", 2, dims=DIMS, n_nodes=N_NODES, n_parts=N_PARTS,
            avg_degree=AVG_DEGREE, cache_mb=CACHE_MB, kernels=mode,
            dense_check=False, device=dev,
        )
        launches[mode] = dict(ops.LAUNCHES)
        for depth, run in r["runs"].items():
            print_run(f"{mode} depth {depth}", run)
        print(f"  {mode}: loss {r['serial_loss']!r}, launches "
              f"{launches[mode]}", flush=True)
        check(r["finite"], f"{mode}: loss and gradients finite")
        check(r["pipeline_matches_serial"],
              f"{mode}: pipelined == serial (loss and every gradient, "
              f"bitwise)")
        check(launches[mode] == expect[mode],
              f"{mode}: launches {launches[mode]} == {expect[mode]}")
        runs[mode] = r["runs"][0]
        del r
        torch.cuda.empty_cache()
    ref, ker, fus = (runs[m] for m in MODES)
    check(ker["losses"] == ref["losses"]
          and all(torch.equal(a[k], b[k])
                  for a, b in zip(ker["grads"][0], ref["grads"][0])
                  for k in a),
          "kernel == reference (loss and every gradient, bitwise)")
    le = abs(fus["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    ge = grads_rel_err(ref["grads"][0], fus["grads"][0])
    check(le <= 1e-4 and ge <= 5e-4,
          f"kernel-fused within 1e-4 of reference on the loss (rel {le:.3e}) "
          f"and 5e-4 on the gradients (max rel {ge:.3e})")
    return launches


# ----------------------------------------------------------------- phase E
def phase_e(dev):
    import shutil
    import tempfile

    import torch

    from repro_torch.core.cache import HostCache
    from repro_torch.core.counters import Counters
    from repro_torch.core.engine import SSOEngine
    from repro_torch.core.storage import StorageTier
    from repro_torch.graph.synthetic import random_features, random_labels
    from repro_torch.launch.infer import _smoke_graph
    from repro_torch.launch.train import _train_smoke
    from repro_torch.models.gnn.layers import get_gnn
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.runtime import PipelineConfig
    from repro_torch.train import EpochLoopConfig, run_epoch_loop

    print(f"phase E: {E_NODES} nodes at widths {DIMS} vs a dense autograd "
          f"oracle; checkpointed epoch loop with a resume", flush=True)
    for mode in MODES:
        r = _train_smoke(
            "gcn", 2, dims=DIMS, n_nodes=E_NODES, n_parts=E_PARTS,
            avg_degree=AVG_DEGREE, cache_mb=E_CACHE_MB, kernels=mode,
            dense_check=True, device=dev,
        )
        check(r["finite"] and r["pipeline_matches_serial"],
              f"{mode}: finite, pipelined == serial (bitwise)")
        check(r["dense_loss_rel_err"] <= 1e-4
              and r["dense_grad_rel_err"] <= 5e-4,
              f"{mode}: loss within 1e-4 (rel {r['dense_loss_rel_err']:.3e}) "
              f"and gradients within 5e-4 (max rel "
              f"{r['dense_grad_rel_err']:.3e}) of the dense oracle")
        del r
        torch.cuda.empty_cache()

    g, plan = _smoke_graph(E_NODES, AVG_DEGREE, E_PARTS, dev)
    X = random_features(g.n_nodes, DIMS[0], 0)[plan.ro.perm]
    Y = random_labels(g.n_nodes, DIMS[-1], 0)[plan.ro.perm]
    spec = get_gnn("gcn")

    def loop(ckpt, crash_at=None):
        c = Counters()
        st = StorageTier(tempfile.mkdtemp(), counters=c)
        eng = SSOEngine(spec, plan, DIMS, st,
                        HostCache(E_CACHE_MB << 20, st, c), c,
                        pipeline=PipelineConfig(depth=2, kernels="kernel"),
                        device=dev)
        eng.initialize(X)

        def epoch_fn(p, e):
            if e == crash_at:
                raise RuntimeError("simulated crash")
            return eng.run_epoch(p, Y)

        params = spec.init(torch.Generator().manual_seed(0), DIMS[0],
                           DIMS[1], DIMS[-1], len(DIMS) - 1, device=dev)
        try:
            return run_epoch_loop(
                EpochLoopConfig(epochs=3, ckpt_dir=ckpt), params,
                adamw_init(params), epoch_fn,
                lambda gr, p, o: adamw_update(gr, p, o, lr=1e-3),
                log_fn=lambda m: print(f"    {m}", flush=True),
            )
        finally:
            eng.close()
            st.close()

    ref_params, _, ref_losses = loop(None)
    ckpt = tempfile.mkdtemp()
    try:
        try:
            loop(ckpt, crash_at=2)
        except RuntimeError as e:
            print(f"    crashed as planned: {e}", flush=True)
        got_params, _, losses = loop(ckpt)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    check(losses == ref_losses and ref_losses[0] != ref_losses[-1],
          f"resumed loop's losses == uninterrupted run's {ref_losses}")
    check(all(torch.equal(a, b) for a, b in
              zip(ref_params.parameters(), got_params.parameters())),
          "resumed from the epoch-2 checkpoint: final parameters == the "
          "uninterrupted run's (bitwise)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # float32 means float32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load("gather_scatter")
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    print(_build.build_log("gather_scatter").strip(), flush=True)

    t_all = time.perf_counter()
    # B first: the launcher keeps one graph, so the full-width one is then
    # built once for A, C and D
    phase_b(dev)
    plan = build_full_width(dev)
    results = phase_a(plan, DIMS[0], dev)
    t0 = time.perf_counter()
    serving = phase_c(plan, dev)
    print(f"phase C: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    training = phase_d(plan, dev)
    print(f"phase D: {time.perf_counter() - t0:.1f} s", flush=True)
    del plan
    t0 = time.perf_counter()
    phase_e(dev)
    print(f"phase E: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"all phases: {time.perf_counter() - t_all:.1f} s", flush=True)

    kernels = []
    for name, r in results.items():
        # each kernel's launches over the serving and training paths, every
        # mode's count read right after that mode's two runs
        n = sum(serving[m][name] + training[m][name] for m in MODES)
        kernels.append(dict(
            name=name, route="cuda", source=KERNEL_SOURCE,
            replaces=REPLACES[name], launches=n, **r,
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
