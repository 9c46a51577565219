#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch/``).

    python3 chip_smoke.py            # one CUDA card, nvcc under /usr/local/cuda

Builds the CUDA kernels from the sources in this checkout, then:

- Phase A: each kernel against its plain PyTorch version at the shapes the
  main path gives it (the largest layer-0 unit of phase C's plan):
  ``gather_rows`` bitwise; ``gather_aggregate`` bitwise against the numpy
  FMA oracle at small shapes and, at the main-path shape, within
  ``(deg_row + 1) * 2^-23 * sum_e |w_e x_e|`` of the plain version. Prints
  kernel, plain, bound and library (``index_select`` / CSR
  ``torch.sparse.mm``) times; the port never calls the library ops.
- Phase B: the port's ``launch.infer`` default smoke on the card (2000
  nodes, dims [24, 32, 8]): finite, pipelined == serial, served == dense.
- Phase C, the main path at full width: ``gcn-igbm-3l`` widths
  [1024, 256, 256, 19] on a 262,144-node Kronecker graph (16
  switching-aware partitions, 512 MB host cache, so the 1.07 GB layer-0
  table is really offloaded), the launcher's ``_infer_smoke`` in modes
  reference, kernel and kernel-fused at pipeline depth 0 and 2. Checks
  kernel == reference and pipelined == serial bitwise, kernel-fused within
  1e-4 of reference, finite tables, server lookups equal to the table on
  storage, and each mode's own launch counts: none in reference, one
  ``gather_rows`` per unit and layer in kernel, one ``gather_aggregate`` per
  unit and layer in kernel-fused.

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
}
MODES = ("reference", "kernel", "kernel-fused")
# phase C: gcn-igbm-3l widths on a 262,144-node graph; a 512 MB host cache
# holds about half of the 1.07 GB layer-0 table
DIMS = [1024, 256, 256, 19]
N_NODES = 262144
AVG_DEGREE = 12
N_PARTS = 16
CACHE_MB = 512


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
    for name, r in results.items():
        print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
              f"{r['library_ms']:.4f} ms, max abs err {r['max_abs_err']:.3e}",
              flush=True)
    del k, p, err, A, stack
    torch.cuda.empty_cache()
    return results


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
        "reference": {"gather_rows": 0, "gather_aggregate": 0},
        "kernel": {"gather_rows": per_path, "gather_aggregate": 0},
        "kernel-fused": {"gather_rows": 0, "gather_aggregate": per_path},
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
    # each kernel's count from the path that launches it
    return {"gather_rows": launches["kernel"]["gather_rows"],
            "gather_aggregate": launches["kernel-fused"]["gather_aggregate"]}


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
    # built once for A and C
    phase_b(dev)
    plan = build_full_width(dev)
    results = phase_a(plan, DIMS[0], dev)
    launches = phase_c(plan, dev)
    print(f"all phases: {time.perf_counter() - t_all:.1f} s", flush=True)

    kernels = []
    for name, r in results.items():
        kernels.append(dict(
            name=name, route="cuda", source=KERNEL_SOURCE,
            replaces=REPLACES[name], launches=launches[name], **r,
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
