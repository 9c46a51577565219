#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch/``).

    python3 chip_smoke.py            # one CUDA card, nvcc under /usr/local/cuda

Builds the CUDA kernels from the sources in this checkout (five packages,
one ``nvcc`` per source, all started together), prints ``nvcc``'s register
and spill report and checks that the bf16 flash kernel's SASS holds
``HGMMA`` (``wgmma``) instructions (``cuobjdump -sass``), then:

- Phase A: each kernel against its plain PyTorch version at the shapes the
  main path gives it (the largest layer-0 unit of phase D's plan; for
  ``scatter_add`` phase D's largest grad write-back that is not one
  contiguous run): ``gather_rows`` bitwise; ``gather_aggregate`` bitwise
  against the numpy FMA oracle at small shapes and, at the main-path shape,
  within ``(deg_row + 1) * 2^-23 * sum_e |w_e x_e|`` of the plain version
  and bitwise against the exact FMA oracle (``gather_aggregate_fma_np``)
  on every row above the split threshold at 4 seeded columns of each
  32-column slab and on 64 seeded ordinary rows at every column, then
  deterministic at D = 256 too; ``scatter_add`` bitwise against the
  ``np.add.at`` oracle at small shapes (duplicates, D = 7, one row, an
  untouched tail) and against its plain version at the main-path shape,
  and deterministic on a rerun; ``edge_softmax`` within ``(deg + 4 + |s -
  m|) * 2^-23`` relative of the float64 numpy oracle at small shapes and,
  at the unit's real edges with H = 4 heads (GAT's hidden layers), within
  ``(deg_row + 4) * 2^-23`` relative of the plain version per element, and
  bitwise on a rerun. Prints kernel, plain, bound and library
  (``index_select`` / CSR ``torch.sparse.mm`` / ``index_add_`` / COO
  ``torch.sparse.softmax``, the last checked against the plain version
  too) times, ``gather_aggregate`` also at D = 256; the port never calls
  the library ops. ``gather_rows`` and ``scatter_add`` (and their library
  calls) are timed as the median device time of 200 launches queued
  behind a sleep (``queued_ms``, a b b a), the rest with ``time_ms``. ``embedding_bag`` bitwise against its plain
  version (and within 1e-5 of a float64 sum) at small shapes with odd
  widths and NaN / wrapped ids, then at phase H's ``serve_bulk`` user-tower
  shape (table 10,000,000 x 256, ids (2,097,152, 16) uniform from numpy
  seed 0) in sum and mean, with kernel, plain, bound and
  ``F.embedding_bag(mode="mean")`` times. ``flash_attention`` in float32
  within 2e-5 of the float64 oracle and in bf16 within 1 bf16 ulp (or 1e-6
  absolute, near 0) of its plain version at small shapes (the JAX kernel
  tests' grid, a ragged S of 200, Sq != Skv both ways, D 8 / 32 / 64 /
  128; causal, window 64, non-causal), then at one prefill launch of phase
  I in bf16 (B 1, S 32,768, 40 query and 10 KV heads of 128, causal):
  within 2^-7 |plain| + 1e-6 of plain elementwise, at least 99% of the
  elements bitwise equal, a rerun bitwise; with kernel, plain, bound (bf16
  tensor-core and float32 rates) and SDPA (flash backend, KV repeated to
  40 heads, checked within 2^-5 of plain) times. ``bsr_spmm``, run right
  after phase C while its 65,536-node graph is the launcher's cached one:
  at small shapes (the JAX kernel test's grid, the reference's empty-row
  fault at B 8, D 7, no block, bf16 x) float32 within ``(m_r + 1) *
  2^-23 * (|A| |X|)_r`` (``m_r`` the row's nonzero entries of A) of the
  plain version and of the float64 oracle, bf16 within 1 ulp of plain (or
  that float32 term), empty block rows exactly 0; then the GCN aggregate
  Â·X of the reordered graph at width 1,024 (``blockify_edges`` of its
  edges with ``gcn_norm_coeffs``, blocks of 128, phase C's layer-0
  features): the main path's one launch counted alone, within the same
  bound of plain (which plain with TF32 products must leave), within
  ``(deg_r + m_r + 1) * 2^-23 * sum_e |w_e x_e|`` of the edge form, kernel
  and plain reruns bitwise; kernel, plain, bound (the nonzero products
  and the bytes; the dense block layout's products printed beside it) and
  library (CSR ``torch.sparse.mm`` of the same edges, checked against the
  edge form) times.
- Phase B: the port's ``launch.infer`` default smoke on the card (2000
  nodes, dims [24, 32, 8]): finite, pipelined == serial, served == dense;
  then the ``launch.train`` and ``launch.infer`` default smokes of each of
  ``sage``, ``gat``, ``gin``, ``pna`` and ``graphcast``, GAT also in
  ``kernel-fused``: finite, pipelined == serial, loss and gradients within
  1e-4 / 5e-4 of the float64 dense oracle, served == table and == dense.
- Phase C, serving at full width: ``gcn-igbm-3l`` widths
  [1024, 256, 256, 19] on a 65,536-node Kronecker graph (16
  switching-aware partitions, 128 MB host cache, so the 268 MB layer-0
  table is really offloaded), the launcher's ``_infer_smoke`` in modes
  reference, kernel and kernel-fused at pipeline depth 0 and 2. Checks
  kernel == reference and pipelined == serial bitwise, kernel-fused within
  1e-4 of reference, finite tables, server lookups equal to the table on
  storage, and each mode's own launch counts: none in reference, one
  ``gather_rows`` per unit and layer in kernel, one ``gather_aggregate`` per
  unit and layer in kernel-fused.
- Phase D, training at full width (the main path): the same widths on a
  262,144-node graph (16 partitions, 512 MB host cache, so the 1.07 GB
  layer-0 table is really offloaded), random labels over 19 classes; the
  launcher's ``_train_smoke``
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
- Phase F, GAT training at full width: the same graph, widths and cache
  (hidden layers 4 heads of 64, the output layer one head of 19), one epoch
  + AdamW in modes reference and kernel-fused at depth 0 and 2. Checks
  finite loss and gradients, pipelined == serial bitwise, kernel-fused
  within 1e-4 (loss) and 5e-4 (gradients) of reference, and exact launch
  counts: ``edge_softmax`` once per (run, forward or backward pass, layer,
  unit with edges), ``gather_rows`` once per (run, pass, layer, unit) and
  phase D's ``scatter_add`` count in kernel-fused; none in reference.
- Phase G, the other families' training at full width: ``sage``,
  ``gin``, ``pna`` and ``graphcast`` at the same widths on a 131,072-node
  graph with a 256 MB host cache (cut from D's 262,144 nodes and 512 MB,
  the same share of the layer-0 table, to keep the script inside its time
  limit), one epoch + AdamW in kernel mode at depth 0 and 2. Checks finite
  loss and gradients, pipelined == serial bitwise, and exact launch
  counts: ``gather_rows`` once per (run, pass, layer, unit) and the
  ``scatter_add`` count of this graph's grad write-backs.
- Phase J, right after G, the micro-batch baseline, the cost model and the
  run records: (1) ``microbatch_grads`` for GCN at D's widths on D's
  graph (``gcn_norm_coeffs`` weights, 8 micro-batches, as
  ``benchmarks/table1_engines.py``) against the whole-graph oracle under
  autograd on the card: loss within 1e-4, every gradient within 1e-4
  max-relative (``tests/test_engine_equivalence.py``'s bounds); prints the
  peak input nodes over |V|, each micro-batch's hop edges, host MFG-build
  and device seconds, peak device GB; (2) the cost model's tiers measured
  (``measure_tiers``) and printed beside ``H100_MACHINE``'s constants,
  with whether the page-cache eviction took (printed, not checked: another
  machine's disk is no fault of the code); (3) ``modeled_time`` and
  ``format_attribution(attribution_report(...))`` of phase D's
  kernel-fused depth-2 run (its epoch's counters, ``gnn_epoch_flops``, its
  measured wall), naming the limiting stage; (4) a pipelined GCN epoch at
  phase B's size under a ``TelemetryServer`` on a free port: ``GET
  /metrics`` holds the byte counters of ``Counters.snapshot()`` exactly;
  (5) ``launch.train --arch gcn-cora --offload --ledger <tmp>``: exit 0
  and one record that ``validate_record`` passes, backend ``cuda``; (6)
  ``examples.train_gnn_offload`` at its defaults: 3 epochs straight, then
  2 with a checkpoint and a resumed run to 3, equal to the straight run
  bitwise. Its runs' kernel launches count in the kernel line.
- Phase H, two-tower retrieval (``two_tower_retrieval`` ``CONFIG``: embed
  256, towers 1024-512-256, 8 user and 4 item fields, bags of 16), weights
  from ``torch.Generator`` seed 0 on the card. Serving at the published
  10,000,000 rows per table (20.5 GB of tables): ``serve_p99`` (batch 512,
  50 queries after 5 of warm-up, p50 / p99), ``serve_bulk`` (batch 262,144,
  wall and lookups/s), ``retrieval_cand`` (a 1,000,000-candidate corpus
  through the item tower in chunks of 65,536, then 30 batch-1 top-128
  queries after 2 of warm-up, p50 / p99). Checks finite outputs, unit L2
  norms within 1e-5, top-1 == argmax of the full score row, kernel ==
  reference bitwise on a ``serve_p99`` batch, and exact ``embedding_bag``
  launch counts. Training at the published widths with 2,000,000 rows per
  table and batch 16,384 (cuts: 10 M rows would need 82 GB for weights,
  gradients and AdamW's moments; the in-batch logits are 17 GB each at
  ``train_batch``'s 65,536): kernel == reference bitwise on the first
  step's loss and every gradient, then 20 steps of ``train_two_tower``'s
  ``batch_fn`` through ``run_training_loop``: finite, the loss falls, two
  ``embedding_bag`` and two ``scatter_add`` launches per step; then the
  example's own size (250,000 rows, batch 1,024, bags of 8): 10 steps, a
  restore from the step-10 checkpoint and 10 more, bitwise equal to 20
  straight steps. Prints latencies, walls, lookups/s, achieved TFLOP/s
  (``recsys_model_flops``), peak device GB, one step's gradient and AdamW
  times apart, and ``scatter_add`` bitwise vs plain with times at the user
  table gradient's shape. After each counted run, ``embedding_bag`` at
  every shape that run launched it at (``bag_shape``: serve_p99,
  serve_bulk, a corpus chunk, a retrieval query, the training user and
  item towers, the resume's user and item towers), on that run's tables
  and ids: bitwise its plain version (NaN equal to NaN), its time
  (``queued_ms`` under 0.1 ms, else ``time_ms``), the distinct-row bound
  (``torch.unique``), the one-read-per-lookup floor,
  ``F.embedding_bag``'s time and the shape's launches, then Σ launches ×
  (time − bound).
- Phase E, small: the same widths on a 20,000-node graph, where a dense
  whole-graph autograd oracle fits (float64, on the card): for GCN and
  GAT, each mode's loss within 1e-4 and gradients within 5e-4 of it (where
  float32 takes the other branch of some relu / leaky_relu inputs, of the
  float64 oracle on those branches, as ``launch.train.dense_ok`` says; the
  count of such inputs is printed), GAT's kernel == reference bitwise
  too; then a 3-epoch checkpointed ``run_epoch_loop``
  that crashes in epoch 2 and a second loop that resumes from the epoch-2
  checkpoint: its final parameters equal an uninterrupted run's bitwise.

- Phase I, Phi-3-medium-14B serving (``phi3_medium_14b`` ``CONFIG``: 40
  layers, d_model 5120, 40 query and 10 KV heads of 128, d_ff 17,920,
  vocab 100,352, bf16), weights from ``torch.Generator`` seed 0 on the
  card, tokens from numpy seeds, after everything before it is freed:
  (1) ``make_prefill_step`` in kernel and reference modes at batch 1 and
  4,096 tokens, all 40 layers: last logits within ``LM_KERNEL_TOL``, 40
  ``flash_attention`` launches in kernel mode, none in reference;
  (2) ``prefill_32k`` at batch 1 (cut from 32), 32,768 tokens, one timed
  call after a 1,024-token warm-up (the launcher's ``_lm_prefill``): 40
  launches, finite logits, wall, tokens/s, TFLOP/s, peak device GB;
  (3) ``decode_32k`` at batch 4 (cut from 128): a 32,768-position cache
  filled to 32,736 with seeded normals, then 32 greedy steps
  (``_lm_decode``): finite logits, p50 / p99 ms a step, tokens/s, peak
  GB, no kernel launch (the reference's decode reaches no Pallas kernel);
  (4) a 64-token prompt decoded token by token against ``lm_forward``
  (kernel mode) within ``LM_ROUNDTRIP_TOL``; (5) checks 1 and 4 in
  float32 at the same widths and 2 layers, within ``LM_F32_TOL``.

Any failed check exits non-zero; no phase's failure is caught. TF32 is off
for matmuls and cuDNN (float32 means float32 here). The last line is the
JSON device record; the line before it the per-kernel JSON record.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
import types
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12         # H100 SXM float32, outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
TF32_FLOP_PER_S = 494.7e12     # H100 SXM TF32 tensor cores, dense
GS_SOURCE = "src/repro_torch/kernels/gather_scatter/csrc/gather_scatter.cu"
SOURCE = {
    "gather_rows": GS_SOURCE,
    "gather_aggregate": GS_SOURCE,
    "scatter_add": GS_SOURCE,
    "edge_softmax": "src/repro_torch/kernels/edge_softmax/csrc/edge_softmax.cu",
    "embedding_bag":
        "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "bsr_spmm": "src/repro_torch/kernels/bsr_spmm/csrc/bsr_spmm.cu",
}
REPLACES = {
    "gather_rows": "src/repro/kernels/gather_scatter/gather_scatter.py:50",
    "gather_aggregate": "src/repro/kernels/gather_scatter/gather_scatter.py:91",
    "scatter_add": "src/repro/kernels/gather_scatter/gather_scatter.py:141",
    "edge_softmax": "src/repro/kernels/edge_softmax/edge_softmax.py:40",
    "embedding_bag": "src/repro/kernels/embedding_bag/embedding_bag.py:33",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:72",
    "bsr_spmm": "src/repro/kernels/bsr_spmm/bsr_spmm.py:45",
}
KERNEL_PACKAGES = ("gather_scatter", "edge_softmax", "embedding_bag",
                   "flash_attention", "bsr_spmm")
NO_LAUNCHES = {k: 0 for k in REPLACES}
NEW_FAMILIES = ("sage", "gat", "gin", "pna", "graphcast")
GAT_HEADS = 4                  # GAT's hidden layers (gat_init's default)
MODES = ("reference", "kernel", "kernel-fused")
# phases A, D, F, G: gcn-igbm-3l widths on a 262,144-node graph; a 512 MB
# host cache holds about half of the 1.07 GB layer-0 table
DIMS = [1024, 256, 256, 19]
N_NODES = 262144
AVG_DEGREE = 12
N_PARTS = 16
CACHE_MB = 512
# phase C (serving): the same widths and cache share on a quarter of the
# nodes, to keep the script inside its time limit
C_NODES = 65536
C_CACHE_MB = 128
# phase E: the same widths on a graph whose dense oracle fits the card
E_NODES = 20000
E_PARTS = 8
E_CACHE_MB = 64
# phase G: the same widths on half of D's nodes, the host cache cut with
# them (a share of the layer-0 table as in D), to keep the script inside
# its time limit
G_NODES = 131072
G_CACHE_MB = 256
# phase J: the micro-batch baseline on D's graph with table1_engines'
# n_micro, held to tests/test_engine_equivalence.py's bounds against the
# whole-graph oracle; the tier probes' sizes (a 1 GiB copy on and off the
# card, D's layer-0 table gathered by half its rows, a 2 GiB file); phase
# B's graph for the telemetry scrape
J_MICRO = 8
J_LOSS_TOL = 1e-4
J_GRAD_TOL = 1e-4
J_COPY_BYTES = 1 << 30
J_GATHER_ROWS = N_NODES
J_SSD_ROWS = 1 << 19
J_SSD_BLOCK_ROWS = N_NODES // N_PARTS
B_NODES = 2000
B_AVG_DEGREE = 7
B_PARTS = 6
B_DIMS = [24, 32, 8]
# train_gnn_offload at its defaults: epochs straight, then the same with a
# checkpoint after J_CKPT_EPOCH and a resume from it
J_EXAMPLE_EPOCHS = 3
J_CKPT_EPOCH = 2
# phase H: two-tower training cuts (rows per table, batch) and the
# example's own size for the checkpoint resume
H_TRAIN_VOCAB = 2_000_000
H_TRAIN_BATCH = 16384
H_TRAIN_STEPS = 20
H_RESUME_VOCAB = 250_000
H_RESUME_BATCH = 1024
# phase I: phi3-medium-14b serving; the prefill cell's sequence at batch 1
# (cut from 32), the decode cell at batch 4 (cut from 128) against a
# 32,768-position cache filled to DECODE_FILL, and the checks' lengths
PREFILL_SEQ = 32768
PREFILL_BATCH = 1
PREFILL_WARMUP_SEQ = 1024
CHECK_SEQ = 4096
DECODE_SEQ = 32768
DECODE_BATCH = 4
DECODE_STEPS = 32
DECODE_FILL = DECODE_SEQ - DECODE_STEPS
ROUNDTRIP_SEQ = 64
# phase I's tolerances (max |a - b| / max |a| of the logits). bf16 at full
# depth, 2.5x the card's first readings (PERF.md: 2.03e-2 kernel vs
# reference at CHECK_SEQ tokens, 2.28e-2 decode vs prefill): the two
# routes round the residual stream at other places and 40 random layers
# amplify it. float32 at 2 layers: the same checks, where rounding is
# float32's.
LM_KERNEL_TOL = 5e-2
LM_ROUNDTRIP_TOL = 5e-2
LM_F32_LAYERS = 2
LM_F32_TOL = 1e-4
# queued_ms: the device sleeps ~25 ms (H100 clocks) while the host queues
SLEEP_CYCLES = 50_000_000
# phase A: the main shape against the exact FMA oracle: a seeded sample of
# ordinary rows at every column, every heavy row at this many seeded
# columns of each 32-column slab (every row and slab of the split path, in
# seconds: the heavy rows hold most of the unit's edges)
ORACLE_ORDINARY_ROWS = 64
ORACLE_SLAB_COLS = 4


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


def queued_ms(fns: dict, launches: int = 100) -> dict:
    """Median device ms per launch of each function in ``fns`` (name ->
    callable), for calls too short for ``time_ms``'s host loop: each round
    queues ``launches`` calls, every one between two CUDA events, behind a
    ``torch.cuda._sleep`` long enough that the device never waits on the
    host (checked: the sleep is still running when the last call is
    queued). Rounds in the order a b ... b a, so each function runs
    ``2 * launches`` times."""
    import statistics

    import torch

    names = list(fns)
    times = {n: [] for n in names}
    for n in names:
        fns[n]()
    torch.cuda.synchronize()
    for n in names + names[::-1]:
        evs = [torch.cuda.Event(enable_timing=True)
               for _ in range(launches + 1)]
        torch.cuda._sleep(SLEEP_CYCLES)
        gate = torch.cuda.Event()
        gate.record()
        evs[0].record()
        for ev in evs[1:]:
            fns[n]()
            ev.record()
        queued = not gate.query()
        torch.cuda.synchronize()
        check(queued, f"{n}: {launches} launches queued while the device "
              f"slept")
        times[n] += [a.elapsed_time(b) for a, b in zip(evs, evs[1:])]
    return {n: statistics.median(t) for n, t in times.items()}


def fma_oracle_rows(stack, erows, dst, w, rows, cols=None):
    """``gather_aggregate``'s exact FMA oracle (``ref.gather_aggregate_
    fma_np``, one thread per core) on ``rows`` only, at columns ``cols``
    (all when None): it gets just those rows' edges, in edge order, and
    those columns of their source rows. Returns the ``(len(rows),
    len(cols))`` float32 result and how many of its steps would have
    rounded twice in float64."""
    import os

    import numpy as np
    import torch

    from repro_torch.kernels.gather_scatter import ref

    dst_np = dst.cpu().numpy()
    lo = np.searchsorted(dst_np, rows, "left")
    hi = np.searchsorted(dst_np, rows, "right")
    idx = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])
    uniq, inv = np.unique(erows.cpu().numpy()[idx], return_inverse=True)
    table = stack.index_select(0, torch.from_numpy(uniq).to(stack.device))
    if cols is not None:
        table = table.index_select(1, torch.from_numpy(cols).to(stack.device))
    return ref.gather_aggregate_fma_np(
        table.cpu().numpy(), inv.astype(np.int32),
        np.repeat(np.arange(rows.size), hi - lo), w.cpu().numpy()[idx],
        rows.size, threads=os.cpu_count() or 1)


def dense_report(r: dict) -> str:
    """A ``_train_smoke`` result's errors against its float64 dense oracle,
    with the kink readings where it took them."""
    txt = (f"loss rel {r['dense_loss_rel_err']:.3e}, grads max rel "
           f"{r['dense_grad_rel_err']:.3e} of the float64 oracle")
    if "kink_flips" in r:
        txt += f"; {r['kink_flips']} relu/leaky_relu inputs on the other side " \
               f"of 0 in float32"
    if "dense_grad_rel_err_f32_branches" in r:
        txt += (f", grads max rel {r['dense_grad_rel_err_f32_branches']:.3e} "
                f"of the float64 oracle on float32's branches there")
    return txt


def hgmma_count(build) -> int:
    """``HGMMA`` (wgmma) instructions in the SASS of the built
    ``flash_attention`` library's ``flash_fwd_wgmma`` functions
    (``cuobjdump -sass``)."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True, timeout=120,
    ).stdout
    funcs = sass.split("Function : ")
    return sum(f.count("HGMMA") for f in funcs[1:]
               if "flash_fwd_wgmma" in f.split("\n", 1)[0])


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
def main_unit(plan, dev):
    """The main path's shapes: the largest layer-0 unit of ``plan``, its
    stack row map (exactly what the runner stages for that unit) and its
    real edges. Returns ``(unit, idx, total, erows, dst, w, n_dst)``: the
    stack has ``total + 1`` rows (the last the zero row), ``erows`` are the
    edges' stack rows."""
    import torch

    from repro_torch.runtime.forward import unit_row_map

    u = max(plan.units, key=lambda u: (u.e_pad, u.n_req))
    idx_np, _, total = unit_row_map(plan, u)
    idx = torch.from_numpy(idx_np).to(dev)
    topo = u.topo
    e = topo.n_real_edges
    return (u, idx, total, idx.index_select(0, topo.src[:e]), topo.dst[:e],
            topo.edge_weight[:e], topo.n_dst)


def phase_a(plan, d_in: int, dev):
    import numpy as np
    import torch

    from repro_torch.kernels.gather_scatter import ops, ref

    print("phase A: kernels vs plain versions", flush=True)
    u, idx, total, erows, dst, w, n_dst = main_unit(plan, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    stack = torch.randn((total + 1, d_in), generator=gen, device=dev)
    stack[total] = 0
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
    q = queued_ms({"gather_rows": lambda: ops.gather_rows(stack, idx),
                   "index_select": lambda: torch.index_select(stack, 0, idx)})
    results["gather_rows"] = dict(
        max_abs_err=float((k - p).abs().max()),
        ms=q["gather_rows"],
        plain_ms=time_ms(lambda: ref.gather_rows_ref(stack, idx)),
        bound_ms=b_ms, bound_by=b_by, library_ms=q["index_select"],
    )
    print(f"  gather_rows queued (median of 200 launches each, a b b a): "
          f"kernel {q['gather_rows']:.4f} ms, index_select "
          f"{q['index_select']:.4f} ms; time_ms's 5-call means: kernel "
          f"{time_ms(lambda: ops.gather_rows(stack, idx)):.4f}, index_select "
          f"{time_ms(lambda: torch.index_select(stack, 0, idx)):.4f}",
          flush=True)
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
    # ---- the main shape, bitwise vs the exact FMA oracle: every heavy row
    # (split into 32-column slabs) at ORACLE_SLAB_COLS seeded columns of
    # each slab, so every work item of the split path, and a seeded sample
    # of ordinary rows at every column
    deg_np = deg.cpu().numpy().astype(np.int64)
    heavy = np.flatnonzero(deg_np > ops.HEAVY_EDGES)
    pick = np.random.default_rng(0)
    sample = np.sort(pick.choice(np.flatnonzero(deg_np <= ops.HEAVY_EDGES),
                                 ORACLE_ORDINARY_ROWS, replace=False))
    cols = np.concatenate([
        c0 + np.sort(pick.choice(min(32, d_in - c0), min(ORACLE_SLAB_COLS,
                                                           d_in - c0),
                                 replace=False))
        for c0 in range(0, d_in, 32)])
    t0 = time.perf_counter()
    want_h, twice = fma_oracle_rows(stack, erows, dst, w, heavy, cols)
    want_s, twice_s = fma_oracle_rows(stack, erows, dst, w, sample)
    got_h = k.index_select(0, torch.from_numpy(heavy).to(dev)).index_select(
        1, torch.from_numpy(cols).to(dev)).cpu().numpy()
    got_s = k.index_select(0, torch.from_numpy(sample).to(dev)).cpu().numpy()
    check(np.array_equal(got_h, want_h) and np.array_equal(got_s, want_s),
          f"gather_aggregate bitwise vs the exact FMA oracle at the main "
          f"shape on its {heavy.size} rows of more than {ops.HEAVY_EDGES} "
          f"edges ({int(deg_np[heavy].sum())} of {dst.shape[0]} edges, max "
          f"{int(deg_np.max())}) at {cols.size} seeded columns "
          f"({ORACLE_SLAB_COLS} of each 32-column slab) and "
          f"{ORACLE_ORDINARY_ROWS} seeded ordinary rows at all {d_in} (the "
          f"float64 route would round {twice + twice_s} steps twice; oracle "
          f"{time.perf_counter() - t0:.1f} s)")
    del got_h, got_s, want_h, want_s
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
    del k, p, err
    del stack
    # ---- the same edges at layers 1-2's width: kernel, bound and library
    d1 = DIMS[1]
    narrow = torch.randn((total + 1, d1), generator=gen, device=dev)
    narrow[total] = 0
    n_ms, n_by = bound(uniq * d1 * 4 + 12 * E + n_dst * d1 * 4,
                       2.0 * E * d1)
    check(torch.equal(ops.gather_aggregate(narrow, erows, dst, w, n_dst),
                      ops.gather_aggregate(narrow, erows, dst, w, n_dst)),
          f"gather_aggregate at D={d1} deterministic (rerun bitwise)")
    print(f"  gather_aggregate at D={d1}: kernel "
          f"{time_ms(lambda: ops.gather_aggregate(narrow, erows, dst, w, n_dst)):.4f}"
          f" ms, bound {n_ms:.4f} ms ({n_by}), library CSR torch.sparse.mm "
          f"{time_ms(lambda: torch.sparse.mm(A, narrow)):.4f} ms", flush=True)
    del narrow, A
    results["scatter_add"] = phase_a_scatter(plan, DIMS[1], dev)
    results["edge_softmax"] = phase_a_softmax(u, dev)
    results["embedding_bag"] = phase_a_bag(dev)
    results["flash_attention"] = phase_a_flash(dev)
    for name, r in results.items():
        print_row(name, r)
    torch.cuda.empty_cache()
    return results


def print_row(name: str, r: dict) -> None:
    lib = (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
           else "none")
    print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
          f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
          f"{lib}, max abs err {r['max_abs_err']:.3e}", flush=True)


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
    q = queued_ms({"scatter_add": lambda: ops.scatter_add_(kb, rows, values),
                   "index_add_": lambda: lb.index_add_(0, rows, values)})
    out = dict(
        max_abs_err=float((k - p).abs().max()),
        ms=q["scatter_add"],
        plain_ms=time_ms(lambda: ref.scatter_add_ref(pb, rows, values)),
        bound_ms=b_ms, bound_by=b_by, library_ms=q["index_add_"],
    )
    print(f"  scatter_add queued (median of 200 launches each, a b b a): "
          f"kernel {q['scatter_add']:.4f} ms, index_add_ "
          f"{q['index_add_']:.4f} ms; time_ms's 5-call means: kernel "
          f"{time_ms(lambda: ops.scatter_add_(kb, rows, values)):.4f}, "
          f"index_add_ {time_ms(lambda: lb.index_add_(0, rows, values)):.4f}",
          flush=True)
    del k, p, kb, pb, lb, base, values
    return out


def phase_a_softmax(u, dev) -> dict:
    """``edge_softmax`` within ``(deg + 4 + |s - m|) * 2^-23`` relative of
    the float64 numpy oracle at small shapes (the float32 ``s - m`` rounds
    by ``|s - m| * 2^-24``, which ``exp`` turns into relative error), then
    at unit ``u``'s real edges with ``GAT_HEADS`` heads within
    ``(deg_row + 4) * 2^-23`` relative of its plain version per element
    (both round ``s - m`` alike; the sums' orders differ), with times."""
    import numpy as np
    import torch

    from repro_torch.kernels.edge_softmax import ops, ref

    rng = np.random.default_rng(0)
    for (n, E, H, hub) in [(200, 1500, 1, 0), (300, 2500, 4, 0),
                           (128, 600, 8, 0), (1000, 20000, 4, 9000),
                           (5, 3, 2, 0)]:
        ds = rng.integers(2, n, E)
        ds = np.sort(np.concatenate([ds[ds != n // 2],
                                     np.full(hub, n - 3)])).astype(np.int32)
        sc = rng.standard_normal((ds.size, H), dtype=np.float32)
        got = ops.edge_softmax(*(torch.from_numpy(a).to(dev)
                                 for a in (sc, ds)), n).cpu().numpy()
        want = ref.edge_softmax_np(sc, ds, n)
        smax = np.full((n, H), -np.inf)
        np.maximum.at(smax, ds, sc.astype(np.float64))
        deg = np.bincount(ds, minlength=n)[ds][:, None]
        tol = (deg + 4 + np.abs(sc - smax[ds])) * 2.0 ** -23 * np.abs(want)
        check(bool(np.all(np.abs(got - want) <= tol)),
              f"edge_softmax within (deg+4+|s-m|)*2^-23 of the float64 oracle "
              f"(n={n} E={ds.size} H={H}, hub {hub}, rows 0, 1, {n // 2} "
              f"empty)")

    topo = u.topo
    e = topo.n_real_edges
    dst = topo.dst[:e]
    n_dst = topo.n_dst
    gen = torch.Generator(device=dev).manual_seed(2)
    scores = torch.randn((e, GAT_HEADS), generator=gen, device=dev)
    k = ops.edge_softmax(scores, dst, n_dst)
    p = ref.edge_softmax_ref(scores, dst, n_dst)
    torch.cuda.synchronize()
    check(torch.equal(ops.edge_softmax(scores, dst, n_dst), k),
          "edge_softmax deterministic (rerun bitwise)")
    deg = torch.bincount(dst.long(), minlength=n_dst).to(torch.float32)
    tol = (deg.index_select(0, dst.long())[:, None] + 4) * 2.0 ** -23 * p.abs()
    err = (k - p).abs()
    n_heavy = int((deg > ops.HEAVY_EDGES).sum())
    check(bool(torch.all(err <= tol)),
          f"edge_softmax within (deg+4)*2^-23 relative of plain per element "
          f"at E={e} H={GAT_HEADS} n_dst={n_dst} (max err "
          f"{float(err.max()):.3e}, max deg {int(deg.max())}; {n_heavy} rows "
          f"of more than {ops.HEAVY_EDGES} edges take a block)")
    # scores in and attention out once, the row ids once; sub, exp, add and
    # divide per element
    b_ms, b_by = bound(2 * e * GAT_HEADS * 4 + 4 * e, 4.0 * e * GAT_HEADS)
    # the library yardstick: torch.sparse.softmax over dim 2 of the
    # (H, n_dst, E) COO tensor with entries (h, dst[e], e) is the segment
    # softmax; the tensor is built outside the timed region
    heads = torch.arange(GAT_HEADS, device=dev).repeat_interleave(e)
    edges = torch.arange(e, device=dev)
    A = torch.sparse_coo_tensor(
        torch.stack([heads, dst.long().repeat(GAT_HEADS),
                     edges.repeat(GAT_HEADS)]),
        scores.t().reshape(-1), (GAT_HEADS, n_dst, e),
        check_invariants=True).coalesce()
    del heads, edges
    lib = torch.sparse.softmax(A, 2).coalesce().values()
    lib = lib.view(GAT_HEADS, e).t()
    lerr = (lib - p).abs()
    check(bool(torch.all(lerr <= tol)),
          f"library torch.sparse.softmax within (deg+4)*2^-23 relative of "
          f"plain per element (max err {float(lerr.max()):.3e})")
    del lib, lerr
    out = dict(
        max_abs_err=float(err.max()),
        ms=time_ms(lambda: ops.edge_softmax(scores, dst, n_dst)),
        plain_ms=time_ms(lambda: ref.edge_softmax_ref(scores, dst, n_dst)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.sparse.softmax(A, 2)),
    )
    del k, p, err, tol, scores, A
    return out


def nan_equal(a, b) -> bool:
    """Equal values, NaN where the other is NaN (the card's NaN has its
    own bits, so this is bitwise up to the NaN payload)."""
    import torch

    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def bits_equal(a, b) -> bool:
    """Equal bits, NaN where the other is NaN (unlike ``nan_equal``, -0 and
    +0 differ)."""
    import torch

    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def bag_shape(label: str, table, ids, launches: int) -> dict:
    """``embedding_bag`` (mean, the towers' mode) at one shape the main path
    launches it at, on that path's table and ids: bitwise its plain version
    (NaN equal to NaN), then its time, the distinct-row bound (each distinct
    row read once, ``torch.unique``), the floor with one row read per
    lookup, and ``F.embedding_bag``'s time. Times under 0.1 ms (a first
    ``time_ms`` reading) are ``queued_ms`` medians, the rest ``time_ms``
    means. Printed as one JSON line; ``launches`` is the path's count at
    this shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import ops, ref

    ids = ids.reshape(-1, ids.shape[-1]).contiguous()
    (n_bags, bag), (V, D) = ids.shape, table.shape
    with torch.no_grad():
        table = table.detach()
        k = ops.embedding_bag(table, ids, "mean")
        p = ref.embedding_bag_ref(table, ids, "mean")
        torch.cuda.synchronize()
        check(bits_equal(k, p), f"embedding_bag at {label}: bitwise its "
              f"plain version (ids {tuple(ids.shape)}, table {V} x {D})")
        del k, p
        n_ids = n_bags * bag
        rows = ids.long()
        rows = torch.where(rows < 0, rows + V, rows)
        uniq = int(torch.unique(rows[(rows >= 0) & (rows < V)]).numel())
        out_bytes = n_bags * D * 4
        b_ms, b_by = bound(uniq * D * 4 + 4 * n_ids + out_bytes,
                           float(n_ids * D))
        floor_ms, _ = bound(n_ids * D * 4 + 4 * n_ids + out_bytes, 0.0)
        ids64 = ids.long()       # the library's index type, made untimed
        fns = {"kernel": lambda: ops.embedding_bag(table, ids, "mean"),
               "library": lambda: F.embedding_bag(ids64, table,
                                                  mode="mean")}
        if time_ms(fns["kernel"]) < 0.1:
            t, timer = queued_ms(fns), "queued"
        else:
            t, timer = {n: time_ms(f) for n, f in fns.items()}, "events"
    row = dict(shape=label, n_bags=n_bags, bag=bag, V=V, D=D,
               launches=launches, distinct=uniq, ms=t["kernel"], timer=timer,
               bound_ms=b_ms, bound_by=b_by, floor_ms=floor_ms,
               library_ms=t["library"])
    print(f"  embedding_bag shape {json.dumps(row)}", flush=True)
    del ids64, rows
    return row


def bag_shapes_summary(rows) -> None:
    """Σ launches × (time − bound) over the shapes the main path launches
    ``embedding_bag`` at."""
    gap = sum(r["launches"] * (r["ms"] - r["bound_ms"]) for r in rows)
    print(f"  embedding_bag over {len(rows)} shapes, "
          f"{sum(r['launches'] for r in rows)} launches: "
          f"sum launches x (ms - bound) = {gap:.4f} ms", flush=True)


def phase_a_bag(dev) -> dict:
    """``embedding_bag`` bitwise vs its plain version at small shapes (odd
    widths, duplicates, wrapped and NaN ids; within 1e-5 of a float64 sum
    where every id is valid), then at phase H's ``serve_bulk`` user-tower
    shape in sum and mean, with times (mean mode, the towers' mode)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.base import RECSYS_SHAPES
    from repro_torch.configs.two_tower_retrieval import CONFIG
    from repro_torch.kernels.embedding_bag import ops, ref

    rng = np.random.default_rng(0)
    for (V, D, nb, bs, bad) in [(1000, 7, 333, 5, False),
                                (5000, 256, 1000, 16, False),
                                (300, 33, 64, 40, False),
                                (50, 16, 40, 3, True), (80, 5, 30, 4, True)]:
        table = rng.standard_normal((V, D), dtype=np.float32)
        ids = rng.integers(0, V, (nb, bs)).astype(np.int32)
        ids[::3, -1] = ids[::3, 0]                     # duplicates in a bag
        if bad:                                        # wrapped and NaN ids
            ids[1, 0], ids[4, 1], ids[7, 0], ids[9, 2] = -1, V, -V, -V - 1
        t_d, i_d = (torch.from_numpy(a).to(dev) for a in (table, ids))
        for mode in ("sum", "mean"):
            got = ops.embedding_bag(t_d, i_d, mode)
            plain = ref.embedding_bag_ref(t_d, i_d, mode)
            torch.cuda.synchronize()
            if bad:
                nan_rows = torch.isnan(got).all(1).nonzero()[:, 0].tolist()
                check(nan_equal(got, plain) and nan_rows == [4, 9],
                      f"embedding_bag {mode} == plain with NaN where plain "
                      f"is NaN, bags 4 and 9 NaN (V={V} D={D} n_bags={nb} "
                      f"bag={bs}, ids -1, V, -V, -V-1)")
                continue
            want = table[ids].sum(1, dtype=np.float64) / (
                bs if mode == "mean" else 1)
            check(torch.equal(got, plain) and np.allclose(
                got.cpu().numpy(), want, rtol=1e-5, atol=1e-5),
                f"embedding_bag {mode} bitwise vs plain, within 1e-5 of the "
                f"float64 sum (V={V} D={D} n_bags={nb} bag={bs})")

    # the main path's shape: serve_bulk's user tower at the published vocab
    V, D, bag = CONFIG.user_vocab, CONFIG.embed_dim, CONFIG.bag_size
    n_bags = RECSYS_SHAPES["serve_bulk"]["batch"] * CONFIG.n_user_fields
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((V, D), generator=gen, device=dev)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, V, (n_bags, bag)).astype(np.int32)).to(dev)
    for mode in ("sum", "mean"):
        k = ops.embedding_bag(table, ids, mode)
        p = ref.embedding_bag_ref(table, ids, mode)
        torch.cuda.synchronize()
        check(torch.equal(k, p), f"embedding_bag {mode} bitwise vs plain at "
              f"table {tuple(table.shape)}, ids {tuple(ids.shape)}")
    err = float((k - p).abs().max())      # mean mode, the one timed below
    del p
    check(torch.equal(ops.embedding_bag(table, ids, "mean"), k),
          "embedding_bag deterministic (rerun bitwise)")
    n_ids = n_bags * bag
    uniq = int(torch.unique(ids).numel())
    # each distinct row read once, the ids read once, the output written
    # once; one add per looked-up element
    b_ms, b_by = bound(uniq * D * 4 + 4 * n_ids + n_bags * D * 4,
                       float(n_ids * D))
    lookup_ms, _ = bound(n_ids * D * 4 + 4 * n_ids + n_bags * D * 4, 0.0)
    ids64 = ids.long()           # the library's index type, made untimed
    lib = F.embedding_bag(ids64, table, mode="mean")
    print(f"  embedding_bag: {uniq} distinct rows of {n_ids} lookups; bound "
          f"with one row read per lookup {lookup_ms:.4f} ms; library "
          f"F.embedding_bag max abs diff from plain "
          f"{float((lib - k).abs().max()):.3e}", flush=True)
    del lib
    out = dict(
        max_abs_err=err,
        ms=time_ms(lambda: ops.embedding_bag(table, ids, "mean")),
        plain_ms=time_ms(lambda: ref.embedding_bag_ref(table, ids, "mean")),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.embedding_bag(ids64, table,
                                                   mode="mean")),
    )
    del k, table, ids, ids64
    torch.cuda.empty_cache()
    return out


def phase_a_flash(dev) -> dict:
    """``flash_attention`` at small shapes (the JAX kernel tests' grid, a
    ragged S of 200, Sq != Skv both ways, D 64 and the LM smoke's D 8;
    causal, window 64 and non-causal): float32 within 2e-5 of the float64
    oracle, bf16 within 1 bf16 ulp of the plain version elementwise (or
    1e-6 absolute, near 0). Then
    one prefill launch of phase I in bf16 (B 1, S 32,768, Hq 40, Hkv 10,
    D 128, causal) against the plain version: within 2^-7 |plain| + 1e-6
    elementwise, at least 99% of the elements bitwise equal, a rerun
    bitwise; with kernel, plain and SDPA times."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops, ref

    rng = np.random.default_rng(0)
    shapes = [(1, 128, 128, 4, 4, 32), (2, 256, 256, 8, 2, 64),
              (1, 512, 512, 4, 1, 128), (1, 200, 200, 4, 2, 128),
              (1, 96, 200, 8, 2, 64), (1, 200, 160, 4, 2, 64),
              (2, 40, 40, 8, 2, 8)]
    worst_f32, worst_ulp = 0.0, 0
    for (B, Sq, Skv, Hq, Hkv, D) in shapes:
        q = rng.standard_normal((B, Sq, Hq, D), dtype=np.float32)
        k = rng.standard_normal((B, Skv, Hkv, D), dtype=np.float32)
        v = rng.standard_normal((B, Skv, Hkv, D), dtype=np.float32)
        qd, kd, vd = (torch.from_numpy(a).to(dev) for a in (q, k, v))
        for causal, window in [(True, None), (True, 64), (False, None)]:
            if window is not None and Sq > Skv + window - 1:
                continue
            got = ops.flash_attention(qd, kd, vd, causal, window)
            want = ref.attention_np(q, k, v, causal, window)
            err = np.abs(got.cpu().numpy() - want)
            worst_f32 = max(worst_f32, float(err.max()))
            check(bool(np.all(err <= 2e-5 + 2e-5 * np.abs(want))),
                  f"flash_attention f32 within 2e-5 of the float64 oracle "
                  f"(B={B} Sq={Sq} Skv={Skv} Hq={Hq} Hkv={Hkv} D={D} "
                  f"causal={causal} window={window}; max err "
                  f"{float(err.max()):.3e})")
            qb, kb, vb = (t.to(torch.bfloat16) for t in (qd, kd, vd))
            got = ops.flash_attention(qb, kb, vb, causal, window)
            plain = ref.flash_attention_ref(qb, kb, vb, causal, window)
            ulps = ref.bf16_ulp_distance(got, plain)
            far = ulps > 1
            far_err = float((got.float() - plain.float()).abs()[far].max()) \
                if bool(far.any()) else 0.0
            worst_ulp = max(worst_ulp, int(ulps.max()))
            check(ref.within_one_bf16_ulp(got, plain),
                  f"flash_attention bf16 within 1 ulp (or "
                  f"{ref.BF16_ABS_FLOOR:g}) of plain (same shape and mask; "
                  f"max {int(ulps.max())} ulp; {int(far.sum())} elements "
                  f"past 1 ulp, max abs diff there {far_err:.3e}, at "
                  f"|plain| <= {float(plain.float().abs()[far].max()) if bool(far.any()) else 0.0:.3e})")

    # the main path's shape: one prefill launch of phase I
    B, S, Hq, Hkv, D = 1, PREFILL_SEQ, 40, 10, 128
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, S, Hq, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, S, Hkv, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, S, Hkv, D), generator=gen, device=dev).bfloat16()
    t0 = time.perf_counter()
    kern = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    plain = ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    kf, pf = kern.float(), plain.float()
    err = (kf - pf).abs()
    check(bool(torch.all(err <= 2.0 ** -7 * pf.abs() + 1e-6)),
          f"flash_attention bf16 within 2^-7 |plain| + 1e-6 of plain at "
          f"q {tuple(q.shape)}, k/v {tuple(k.shape)}, causal (max abs err "
          f"{float(err.max()):.3e}; first launch {t_first:.3f} s)")
    same = float((kern == plain).float().mean())
    check(same >= 0.99, f"flash_attention: {same:.6f} of the elements "
          f"bitwise equal to plain (>= 0.99)")
    check(torch.equal(ops.flash_attention(q, k, v), kern),
          "flash_attention deterministic (rerun bitwise)")
    max_err = float(err.max())
    del kf, pf, err
    pairs = B * Hq * S * (S + 1) / 2.0
    flops = 4.0 * D * pairs
    nbytes = 2.0 * (q.numel() + k.numel() + v.numel() + kern.numel())
    t_tc = flops / BF16_FLOP_PER_S * 1e3
    t_f32 = flops / F32_FLOP_PER_S * 1e3
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    # the library yardstick: SDPA (flash backend, bf16 P) on KV repeated to
    # Hq heads, (B, H, S, D), made outside the timed region
    G = Hq // Hkv
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        lib_err = rel_err(plain.float().cpu().numpy(),
                          lib.transpose(1, 2).float().cpu().numpy())
        del lib
        check(lib_err <= 2.0 ** -5,
              f"SDPA (bf16 P) within 2^-5 max-relative of plain "
              f"({lib_err:.3e})")
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
    del qt, kt, vt, plain
    out = dict(
        max_abs_err=max_err,
        ms=time_ms(lambda: ops.flash_attention(q, k, v)),
        plain_ms=time_ms(lambda: ref.flash_attention_ref(q, k, v)),
        bound_ms=max(t_tc, t_b), bound_by="operations" if t_tc >= t_b
        else "bytes",
        library_ms=lib_ms,
    )
    print(f"  flash_attention: small shapes max err {worst_f32:.3e} (f32 vs "
          f"float64), max {worst_ulp} bf16 ulp vs plain; at the prefill "
          f"shape {pairs:.4e} (q, k) pairs, {flops:.4e} FLOP: bound "
          f"{t_tc:.4f} ms at the bf16 tensor-core rate, {t_f32:.4f} ms at "
          f"the float32 rate, {t_b:.4f} ms for the bytes; the kernel's own "
          f"tensor-core floor {2 * t_tc:.4f} ms (P V in three bf16 terms of "
          f"P: twice the products); kernel {flops / out['ms'] / 1e9:.2f} "
          f"TFLOP/s of the attention's FLOP, {2 * t_tc / out['ms']:.3f} of "
          f"its own floor", flush=True)
    del q, k, v, kern
    torch.cuda.empty_cache()
    return out


def bsr_main_inputs(dev, nodes: int = C_NODES, dim: int = DIMS[0]):
    """The ``bsr_spmm`` row's main-path inputs on the card: Â of phase C's
    reordered graph (the launcher's cached ``_smoke_graph``) as nonzero
    blocks of 128 with GCN weights, and the layer-0 features in the
    graph's order. Returns a namespace: ``graph``, ``edges``, ``w`` (host
    arrays), ``a``, ``rows``, ``cols``, ``x``, ``nb``, and the host
    ``blockify_s`` and ``h2d_s`` seconds."""
    import torch

    from repro_torch.graph.csr import gcn_norm_coeffs
    from repro_torch.graph.synthetic import random_features
    from repro_torch.kernels.bsr_spmm import ops
    from repro_torch.launch.infer import _smoke_graph

    _, plan = _smoke_graph(nodes, AVG_DEGREE, N_PARTS, dev)
    g = plan.ro.graph
    ei = g.edge_index()
    w = gcn_norm_coeffs(g)
    t0 = time.perf_counter()
    a, rows, cols, nb = ops.blockify_edges(ei[0], ei[1], w, g.n_nodes)
    blockify_s = time.perf_counter() - t0
    x_np = random_features(nodes, dim, 0)[plan.ro.perm]
    t0 = time.perf_counter()
    a_d = torch.from_numpy(a).to(dev)
    del a
    r_d, c_d, x = (torch.from_numpy(t).to(dev) for t in (rows, cols, x_np))
    torch.cuda.synchronize()
    return types.SimpleNamespace(
        graph=g, edges=ei, w=w, a=a_d, rows=r_d, cols=c_d, x=x, nb=nb,
        blockify_s=blockify_s, h2d_s=time.perf_counter() - t0)


def phase_a_bsr(dev):
    """``bsr_spmm`` at small shapes (the JAX kernel test's grid, the
    reference's empty-row fault at B 8, D 7, no block at all, bf16 x), then
    the main path's aggregate: Â·X of phase C's reordered 65,536-node graph
    (the launcher's cached graph) at layer-0 width, blocks of 128. Float32
    within ``(m_r + 1) * 2^-23 * (|A| |X|)_r`` of the plain version,
    ``m_r`` the row's nonzero entries of A (``bsr_spmm_tolerance``; small
    shapes also of the float64 oracle), bf16 within 1 ulp of plain or that
    float32 term, empty block rows exactly 0; at the main shape a control
    (plain with TF32 products) outside that limit, the kernel within
    ``(deg_r + m_r + 1) * 2^-23 * sum_e |w_e x_e|`` of the edge form,
    kernel and plain reruns bitwise. The bound counts the nonzero
    products, not the dense blocks' (printed beside it). Returns the row and the main path's launches (one call of the public
    ``bsr_spmm`` on the card, counted alone)."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.bsr_spmm import ops, ref
    from repro_torch.kernels.flash_attention.ref import bf16_ulp_distance

    print("phase A (bsr_spmm): kernel vs plain version", flush=True)
    rng = np.random.default_rng(0)
    cases = [(*(rng.integers(0, n, E) for _ in range(2)), n, D, 128,
              torch.float32) for (n, E, D) in
             [(300, 2000, 64), (700, 5000, 128), (128, 400, 96),
              (513, 3000, 32), (200, 900, 7)]]
    cases += [(np.array([0, 9, 17, 3]), np.array([1, 2, 20, 21]), 32, 20, 8,
               torch.float32),
              (np.zeros(0, np.int64), np.zeros(0, np.int64), 256, 64, 128,
               torch.float32),
              (*(rng.integers(0, 256, 1500) for _ in range(2)), 256, 64, 128,
               torch.bfloat16)]
    for (src, dst, n, D, block, dtype) in cases:
        w = rng.standard_normal(src.size, dtype=np.float32)
        a, rows, cols, nb = ops.blockify_edges(src, dst, w, n, block=block)
        x = rng.standard_normal((nb * block, D), dtype=np.float32)
        a_d, r_d, c_d, x_d = (torch.from_numpy(t).to(dev)
                              for t in (a, rows, cols, x))
        x_d = x_d.to(dtype)
        got = ops.bsr_spmm(x_d, a_d, r_d, c_d, nb, block=block)
        xb = x_d.view(nb, block, D)
        plain = ref.bsr_spmm_ref(a_d, r_d, c_d, xb, nb).view(-1, D)
        tol = ref.bsr_spmm_tolerance(a_d, r_d, c_d, xb, nb).view(-1, D)
        err = (got.float() - plain.float()).abs()
        if dtype == torch.float32:
            want = ref.bsr_spmm_np(a, rows, cols, x.reshape(nb, block, D), nb)
            ok = bool(torch.all(err <= tol)) and bool(np.all(
                np.abs(got.cpu().numpy() - want.reshape(-1, D))
                <= tol.cpu().numpy()))
            what = "of plain and of the float64 oracle"
        else:
            ok = bool(torch.all((bf16_ulp_distance(got, plain) <= 1)
                                | (err <= tol)))
            what = "bf16: 1 ulp of plain, or the float32 term"
        empty = np.setdiff1d(np.arange(nb), rows)
        blocks = got.view(nb, block, D)
        zeros = not bool(blocks[torch.from_numpy(empty).to(dev)].any())
        check(ok and zeros,
              f"bsr_spmm within (m_r+1)*2^-23*|A||X| {what} (n={n} "
              f"E={src.size} D={D} B={block}, {a.shape[0]} blocks, max err "
              f"{float(err.max()) if err.numel() else 0.0:.3e}); "
              f"{empty.size} empty block rows exactly 0")

    # the main path's shape: the GCN aggregate of phase C's graph
    laps = [("", time.perf_counter())]

    def lap(name: str) -> None:
        torch.cuda.synchronize()
        laps.append((name, time.perf_counter()))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mi = bsr_main_inputs(dev)
    g, a_d, r_d, c_d, x, nb = mi.graph, mi.a, mi.rows, mi.cols, mi.x, mi.nb
    D = x.shape[1]
    nnz = a_d.shape[0]
    per_row = torch.bincount(r_d, minlength=nb).cpu().numpy()
    print(f"  bsr_spmm main shape: {g.n_nodes} nodes, {g.n_edges} edges, D "
          f"{D}: {nnz} nonzero blocks of 128 ({a_d.numel() * 4 / 1e9:.2f} GB"
          f", {g.n_edges / nnz:.1f} edges a block), {int((per_row > 0).sum())}"
          f" of {nb} block rows hit, blocks per row mean "
          f"{per_row.mean():.1f} max {int(per_row.max())}; blockify "
          f"{mi.blockify_s:.2f} s on the host, to the card {mi.h2d_s:.2f} s",
          flush=True)
    lap("data")

    reset_launches()              # this path's launches start here
    out = ops.bsr_spmm(x, a_d, r_d, c_d, nb)
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches == dict(NO_LAUNCHES, bsr_spmm=1),
          f"bsr_spmm main path: launches {launches}")
    xb = x.view(nb, 128, D)
    plain = ref.bsr_spmm_ref(a_d, r_d, c_d, xb, nb).view(-1, D)
    torch.cuda.synchronize()
    check(torch.equal(ops.bsr_spmm(x, a_d, r_d, c_d, nb), out),
          "bsr_spmm deterministic (rerun bitwise)")
    check(torch.equal(ref.bsr_spmm_ref(a_d, r_d, c_d, xb, nb).view(-1, D),
                      plain), "plain bsr_spmm deterministic (rerun bitwise)")
    tol = ref.bsr_spmm_tolerance(a_d, r_d, c_d, xb, nb).view(-1, D)
    tiny = torch.finfo(torch.float32).tiny
    err = (out - plain).abs()
    max_err = float(err.max())
    share = float((err / tol.clamp_min(tiny)).max())
    check(share <= 1,
          f"bsr_spmm within (m_r+1)*2^-23*|A||X| of plain at {nnz} blocks, "
          f"D={D} (max err {max_err:.3e}, {share:.3e} of the limit at most)")
    del err
    # the limit's power: the plain version with TF32 products leaves it
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctrl = ref.bsr_spmm_ref(a_d, r_d, c_d, xb, nb).view(-1, D)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ctrl_share = float(((ctrl - plain).abs() / tol.clamp_min(tiny)).max())
    check(ctrl_share > 1,
          f"control: plain with TF32 products outside the limit "
          f"({ctrl_share:.3e} of it at most)")
    del ctrl
    lap("kernel vs plain")
    # the edge form of the same product, on the card
    ei, w = mi.edges, mi.w
    src_d, dst_d, w_d = (torch.from_numpy(t).to(dev) for t in (ei[0], ei[1], w))
    edges = ref.spmm_edges_ref(src_d, dst_d, w_d, x, g.n_nodes)
    mag = ref.spmm_edges_ref(src_d, dst_d, w_d.abs(), x.abs(), g.n_nodes)
    deg = torch.bincount(dst_d.long(), minlength=g.n_nodes).float()
    m_r = ref.row_nonzeros(a_d, r_d, nb).view(-1)
    n_nz = int(m_r.sum())
    tol_e = (deg + m_r.float() + 1)[:, None] * 2.0 ** -23 * mag
    del mag
    e_err = (out - edges).abs()
    check(bool(torch.all(e_err <= tol_e)),
          f"bsr_spmm within (deg+m_r+1)*2^-23*sum|w x| of the edge form "
          f"(max err {float(e_err.max()):.3e}, max deg {int(deg.max())}, "
          f"max m_r {int(m_r.max())})")
    del e_err
    lap("edge form")

    # the least work of Â·X: each block, x and the output moved once, and
    # one multiply-add per nonzero entry of A and column of x
    flops = 2.0 * n_nz * D
    b_ms, b_by = bound(a_d.numel() * 4 + 8 * nnz + 2 * x.numel() * 4, flops)
    dense = 2.0 * nnz * 128 * 128 * D     # what the dense block layout does
    # the library yardstick, built outside the timed region: CSR
    # torch.sparse.mm on the same edges. (BSR `bsr @ x` on the same blocks,
    # which PyTorch sends to its own Triton kernel, is not timed here: it
    # is wrong past 2^31 value entries and spends ~29 s in its first call;
    # scripts/pt_bsr_library.py measures it.)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "CSR is beta"
        csr = torch.sparse_coo_tensor(
            torch.stack([dst_d.long(), src_d.long()]), w_d,
            size=(g.n_nodes, g.n_nodes), check_invariants=True,
        ).coalesce().to_sparse_csr()
        c_err = (torch.sparse.mm(csr, x) - edges).abs()
        check(bool(torch.all(c_err <= tol_e)),
              f"library CSR torch.sparse.mm within the edge-form bound of "
              f"the edge form (max err {float(c_err.max()):.3e})")
        del c_err, tol, tol_e, edges
        lib_ms = time_ms(lambda: torch.sparse.mm(csr, x))
    lap("library")
    row = dict(
        max_abs_err=max_err,
        ms=time_ms(lambda: ops.bsr_spmm(x, a_d, r_d, c_d, nb)),
        plain_ms=time_ms(lambda: ref.bsr_spmm_ref(a_d, r_d, c_d, xb, nb)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
    )
    lap("timing")
    print(f"  bsr_spmm: {n_nz} nonzero entries of A, {flops:.4e} FLOP of "
          f"nonzero products; bound {b_ms:.4f} ms ({b_by}; operations "
          f"{flops / F32_FLOP_PER_S * 1e3:.4f} ms at float32's rate); the "
          f"dense block layout's products {dense:.4e} FLOP, "
          f"{dense / flops:.0f}x, {dense / F32_FLOP_PER_S * 1e3:.4f} ms at "
          f"float32's rate ({dense / TF32_FLOP_PER_S * 1e3:.4f} ms at "
          f"TF32's: the first design's work); kernel {row['ms'] / b_ms:.1f}x"
          f" its bound, {row['ms'] / lib_ms:.1f}x the library call;"
          f" library CSR torch.sparse.mm of the edges {lib_ms:.4f} ms; peak "
          f"device {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; main "
          f"shape {laps[-1][1] - laps[0][1]:.1f} s (" + ", ".join(
              f"{name} {t - laps[i][1]:.1f}"
              for i, (name, t) in enumerate(laps[1:])) + ")", flush=True)
    print_row("bsr_spmm", row)
    del out, plain, a_d, r_d, c_d, x, xb, src_d, dst_d, w_d, csr
    torch.cuda.empty_cache()
    return row, launches["bsr_spmm"]


# ----------------------------------------------------------------- phase B
def phase_b(dev):
    from repro_torch.launch.infer import _infer_smoke
    from repro_torch.launch.train import _train_smoke, dense_ok

    print("phase B: launch.infer default smoke on the card", flush=True)
    r = _infer_smoke("gcn", 2, device=dev)
    r.pop("runs")
    print(f"  {r}", flush=True)
    check(r["finite"], "phase B table finite")
    check(r["pipeline_matches_serial"], "phase B pipelined == serial (bitwise)")
    check(r["serve_matches_table"], "phase B served == table on storage")
    check(r["serve_matches_dense"], "phase B served == dense forward")
    for model in NEW_FAMILIES:
        for kernels in (("auto", "kernel-fused") if model == "gat"
                        else ("auto",)):
            t0 = time.perf_counter()
            r = _train_smoke(model, 2, kernels=kernels, device=dev)
            check(r["finite"] and r["pipeline_matches_serial"]
                  and dense_ok(r),
                  f"phase B launch.train {model} ({kernels}): finite, "
                  f"pipelined == serial, {dense_report(r)}")
            r = _infer_smoke(model, 2, kernels=kernels, device=dev)
            check(r["finite"] and r["pipeline_matches_serial"]
                  and r["serve_matches_table"] and r["serve_matches_dense"],
                  f"phase B launch.infer {model} ({kernels}): finite, "
                  f"pipelined == serial, served == table == dense "
                  f"({time.perf_counter() - t0:.1f} s both)")
            del r


# ----------------------------------------------------------------- phase C
def phase_c(dev):
    import numpy as np

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.infer import _infer_smoke, _smoke_graph

    print(f"phase C: offloaded inference at full width {DIMS}, {C_NODES} "
          f"nodes, {C_CACHE_MB} MB host cache", flush=True)
    # the launcher's own graph and plan (kept in its one-entry cache)
    _, plan = _smoke_graph(C_NODES, AVG_DEGREE, N_PARTS, dev)
    # one launch per unit and layer in each of the two runs (depth 0, 2)
    per_path = 2 * (len(DIMS) - 1) * sum(
        1 for p in plan.schedule if plan.unit(p).n_edges > 0)
    expect = {
        "reference": dict(NO_LAUNCHES),
        "kernel": dict(NO_LAUNCHES, gather_rows=per_path),
        "kernel-fused": dict(NO_LAUNCHES, gather_aggregate=per_path),
    }
    tables = {}
    launches = {}
    for mode in MODES:
        reset_launches()          # this path's launches start here
        r = _infer_smoke(
            "gcn", 2, cache_mb=C_CACHE_MB, serve_cache_kb=4096, queries=16,
            batch=256, dims=DIMS, n_nodes=C_NODES, n_parts=N_PARTS,
            avg_degree=AVG_DEGREE, kernels=mode, dense_check=False,
            device=dev,
        )
        launches[mode] = launch_counts()
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

    from repro_torch.kernels import launch_counts, reset_launches
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
        "reference": dict(NO_LAUNCHES),
        "kernel": dict(NO_LAUNCHES, gather_rows=2 * 2 * L * units,
                       scatter_add=scatters),
        "kernel-fused": dict(NO_LAUNCHES, gather_rows=2 * L * units,
                             gather_aggregate=2 * L * fused_units,
                             scatter_add=scatters),
    }
    runs = {}
    launches = {}
    for mode in MODES:
        reset_launches()          # this path's launches start here
        r = _train_smoke(
            "gcn", 2, dims=DIMS, n_nodes=N_NODES, n_parts=N_PARTS,
            avg_degree=AVG_DEGREE, cache_mb=CACHE_MB, kernels=mode,
            dense_check=False, device=dev,
        )
        launches[mode] = launch_counts()
        if mode == "kernel-fused":
            fused = r["runs"][2]      # phase J's cost model reads this run
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
    return launches, fused


# ----------------------------------------------------------------- phase F
def phase_f(plan, dev):
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.train import _train_smoke

    print(f"phase F: GAT offloaded training at full width {DIMS}, "
          f"{CACHE_MB} MB host cache, one epoch + AdamW", flush=True)
    L = len(DIMS) - 1
    units = len(plan.schedule)
    edge_units = sum(1 for p in plan.schedule if plan.unit(p).n_edges > 0)
    scatters = 2 * (L - 1) * len(scatter_row_sets(plan))
    # two runs (depth 0, 2) x two passes (the forward, the backward's
    # recompute) per layer and unit; the softmax only where a unit has edges
    expect = {
        "reference": dict(NO_LAUNCHES),
        "kernel-fused": dict(NO_LAUNCHES, gather_rows=2 * 2 * L * units,
                             scatter_add=scatters,
                             edge_softmax=2 * 2 * L * edge_units),
    }
    runs = {}
    launches = {}
    for mode in expect:
        reset_launches()          # this path's launches start here
        r = _train_smoke(
            "gat", 2, dims=DIMS, n_nodes=N_NODES, n_parts=N_PARTS,
            avg_degree=AVG_DEGREE, cache_mb=CACHE_MB, kernels=mode,
            dense_check=False, device=dev,
        )
        launches[mode] = launch_counts()
        for depth, run in r["runs"].items():
            print_run(f"gat {mode} depth {depth}", run)
        print(f"  gat {mode}: loss {r['serial_loss']!r}, launches "
              f"{launches[mode]}", flush=True)
        check(r["finite"], f"gat {mode}: loss and gradients finite")
        check(r["pipeline_matches_serial"],
              f"gat {mode}: pipelined == serial (loss and every gradient, "
              f"bitwise)")
        check(launches[mode] == expect[mode],
              f"gat {mode}: launches {launches[mode]} == {expect[mode]}")
        runs[mode] = r["runs"][0]
        del r
        torch.cuda.empty_cache()
    ref, fus = runs["reference"], runs["kernel-fused"]
    le = abs(fus["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    ge = grads_rel_err(ref["grads"][0], fus["grads"][0])
    check(le <= 1e-4 and ge <= 5e-4,
          f"gat kernel-fused within 1e-4 of reference on the loss (rel "
          f"{le:.3e}) and 5e-4 on the gradients (max rel {ge:.3e})")
    return launches


# ----------------------------------------------------------------- phase G
def phase_g(dev):
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.infer import _smoke_graph
    from repro_torch.launch.train import _train_smoke

    print(f"phase G: sage, gin, pna, graphcast offloaded training at full "
          f"width {DIMS}, {G_NODES} nodes, {G_CACHE_MB} MB host cache, one "
          f"epoch + AdamW, kernel mode", flush=True)
    # the launcher's own graph and plan at G's size (kept in its one-entry
    # cache for the runs below)
    _, plan = _smoke_graph(G_NODES, AVG_DEGREE, N_PARTS, dev)
    L = len(DIMS) - 1
    units = len(plan.schedule)
    # two runs (depth 0, 2) x two passes (forward, backward regather) per
    # layer and unit, and phase D's grad write-backs
    expect = dict(NO_LAUNCHES, gather_rows=2 * 2 * L * units,
                  scatter_add=2 * (L - 1) * len(scatter_row_sets(plan)))
    launches = {}
    for model in ("sage", "gin", "pna", "graphcast"):
        t0 = time.perf_counter()
        reset_launches()          # this path's launches start here
        r = _train_smoke(
            model, 2, dims=DIMS, n_nodes=G_NODES, n_parts=N_PARTS,
            avg_degree=AVG_DEGREE, cache_mb=G_CACHE_MB, kernels="kernel",
            dense_check=False, device=dev,
        )
        launches[model] = launch_counts()
        for depth, run in r["runs"].items():
            print_run(f"{model} depth {depth}", run)
        print(f"  {model}: loss {r['serial_loss']!r}, launches "
              f"{launches[model]} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        check(r["finite"], f"{model}: loss and gradients finite")
        check(r["pipeline_matches_serial"],
              f"{model}: pipelined == serial (loss and every gradient, "
              f"bitwise)")
        check(launches[model] == expect,
              f"{model}: launches {launches[model]} == {expect}")
        del r
        torch.cuda.empty_cache()
    return launches


# ----------------------------------------------------------------- phase J
def phase_j_microbatch(g, dev) -> None:
    """``microbatch_grads`` (GCN at ``DIMS``, ``J_MICRO`` micro-batches,
    ``gcn_norm_coeffs`` weights) against the whole-graph oracle's loss and
    gradients under autograd, on ``g``."""
    import numpy as np
    import torch

    from repro_torch.core.microbatch import microbatch_grads
    from repro_torch.graph.csr import gcn_norm_coeffs
    from repro_torch.graph.synthetic import random_features, random_labels
    from repro_torch.launch.train import _reset_peak
    from repro_torch.models.gnn.layers import (
        full_graph_loss, full_graph_topo, get_gnn,
    )

    n, e = g.n_nodes, g.n_edges
    print(f"phase J: micro-batch baseline, GCN {DIMS}, {J_MICRO} "
          f"micro-batches, vs the whole-graph oracle: {n} nodes, {e} edges",
          flush=True)
    spec = get_gnn("gcn")
    ew = gcn_norm_coeffs(g)
    X = random_features(n, DIMS[0], 0)
    Y = random_labels(n, DIMS[-1], 0)
    params = spec.init(torch.Generator().manual_seed(0), DIMS[0], DIMS[1],
                       DIMS[-1], len(DIMS) - 1, device=dev)
    _reset_peak(dev)
    t0 = time.perf_counter()
    loss, grads, st = microbatch_grads(spec, params, g, X, Y, J_MICRO,
                                       edge_weight=ew, device=dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    inner = sum(h[0] for h in st["hop_edges"])
    print(f"  micro-batch epoch: wall {wall:.3f} s, of it host (MFG builds, "
          f"input features' row gathers) {st['host_s']:.3f} s and device "
          f"(features' copy, forward, backward) {st['device_s']:.3f} s; "
          f"peak device {peak:.2f} GB", flush=True)
    print(f"  peak input nodes {st['peak_input_nodes']} = "
          f"{st['peak_input_nodes'] / n:.4f} |V|; input nodes per "
          f"micro-batch {st['input_nodes']}", flush=True)
    print(f"  hop edges, innermost first, per micro-batch "
          f"{st['hop_edges']} (|E| = {e}); layer-0 edge work {inner} = "
          f"{inner / e:.3f} |E|", flush=True)
    _reset_peak(dev)
    t0 = time.perf_counter()
    topo = full_graph_topo(g.indptr, g.indices, n, ew, device=dev)
    with torch.enable_grad():
        oracle = full_graph_loss(spec, params, X, topo, Y)
        want = torch.autograd.grad(oracle, list(params.parameters()))
    oracle = float(oracle.detach())
    torch.cuda.synchronize(dev)
    print(f"  whole-graph oracle: wall {time.perf_counter() - t0:.3f} s, "
          f"peak device {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB",
          flush=True)
    del topo
    got = [t for layer in grads for t in layer.values()]
    le = abs(loss - oracle)
    check(bool(np.isfinite(loss)) and le <= J_LOSS_TOL,
          f"micro-batch loss {loss!r} within {J_LOSS_TOL} of the "
          f"whole-graph oracle's {oracle!r} ({le:.3e})")
    ge = max(rel_err(w.cpu().numpy(), t.cpu().numpy())
             for w, t in zip(want, got))
    check(all(bool(torch.isfinite(t).all()) for t in got)
          and ge <= J_GRAD_TOL,
          f"micro-batch gradients finite and within {J_GRAD_TOL} "
          f"max-relative of the oracle's ({ge:.3e})")
    torch.cuda.empty_cache()


def device_read_bytes():
    """Bytes this process has had fetched from storage devices so far
    (``read_bytes`` of ``/proc/self/io``), or None where the kernel does
    not say."""
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("read_bytes:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


def measure_tiers(dev) -> dict:
    """The cost model's tiers where the script runs, bytes/s: ``hbm`` a 1 GiB
    device-to-device copy (read + written), ``host_link`` pinned H2D and D2H
    copies of 1 GiB (both ways over their summed times; ``h2d`` / ``d2h``
    apart), ``host_mem`` a numpy row gather (``np.take``, as
    ``ForwardRunner.gather``) of half of D's layer-0 table's rows by a
    seeded index (bytes gathered, best of 3), ``ssd`` a ``StorageTier``
    file of 2 GiB written, ``fsync``ed and evicted (``StorageTier.evict``),
    read in blocks of D's partition size (``ssd_fetched``: the bytes that
    read fetched from the device, None if unknown); ``ssd_warm`` the same
    read again from the page cache."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core.storage import StorageTier

    out = {}
    n = J_COPY_BYTES // 4
    a = torch.ones(n, device=dev)
    b = torch.empty_like(a)
    out["hbm"] = 2 * J_COPY_BYTES / (time_ms(lambda: b.copy_(a), 10) / 1e3)
    h = torch.ones(n).pin_memory()
    h2d = time_ms(lambda: b.copy_(h, non_blocking=True), 10)
    d2h = time_ms(lambda: h.copy_(a, non_blocking=True), 10)
    out["h2d"] = J_COPY_BYTES / (h2d / 1e3)
    out["d2h"] = J_COPY_BYTES / (d2h / 1e3)
    out["host_link"] = 2 * J_COPY_BYTES / ((h2d + d2h) / 1e3)
    del a, b, h
    rng = np.random.default_rng(0)
    table = rng.standard_normal((J_GATHER_ROWS, DIMS[0]), dtype=np.float32)
    idx = rng.integers(0, J_GATHER_ROWS, J_GATHER_ROWS // 2)
    buf = np.empty((idx.size, DIMS[0]), np.float32)
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        np.take(table, idx, axis=0, out=buf, mode="clip")
        best = min(best, time.perf_counter() - t0)
    out["host_mem"] = buf.nbytes / best
    st = StorageTier(tempfile.mkdtemp(prefix="chip_smoke_tier_"))
    blk = J_SSD_BLOCK_ROWS
    try:
        st.alloc("tier", (J_SSD_ROWS, DIMS[0]))
        for r0 in range(0, J_SSD_ROWS, blk):
            st.write_rows("tier", r0, table[:blk])
        st.evict("tier")

        def read_all() -> float:
            t0 = time.perf_counter()
            for r0 in range(0, J_SSD_ROWS, blk):
                st.read_rows("tier", r0, r0 + blk)
            return time.perf_counter() - t0

        before = device_read_bytes()
        cold = read_all()
        after = device_read_bytes()
        warm = read_all()
    finally:
        st.close()
    nbytes = J_SSD_ROWS * DIMS[0] * 4
    out["ssd"] = nbytes / cold
    out["ssd_warm"] = nbytes / warm
    out["ssd_bytes"] = nbytes
    out["ssd_fetched"] = (None if before is None or after is None
                          else after - before)
    return out


def phase_j_tiers(smi: str, dev) -> None:
    from repro_torch.core.costmodel import H100_MACHINE

    t = measure_tiers(dev)
    prof = H100_MACHINE
    print(f"  tiers measured ({smi}), GB/s, beside the H100_MACHINE "
          f"profile's: hbm {t['hbm'] / 1e9:.1f} ({prof.hbm / 1e9:.1f}), "
          f"host_link {t['host_link'] / 1e9:.2f} ({prof.host_link / 1e9:.2f};"
          f" h2d {t['h2d'] / 1e9:.2f}, d2h {t['d2h'] / 1e9:.2f}), host_mem "
          f"{t['host_mem'] / 1e9:.2f} ({prof.host_mem / 1e9:.2f}), ssd "
          f"{t['ssd'] / 1e9:.3f} ({prof.ssd / 1e9:.3f}; warm re-read "
          f"{t['ssd_warm'] / 1e9:.3f}); peak_flops {prof.peak_flops:.3g} "
          f"(data sheet)", flush=True)
    fetched = t["ssd_fetched"]
    if fetched is None:
        took = "cannot be told (no /proc/self/io)"
    else:
        took = ("took" if fetched >= 0.9 * t["ssd_bytes"] else "did not "
                "take") + (f": the cold read fetched {fetched / 1e9:.3f} GB "
                           f"of {t['ssd_bytes'] / 1e9:.3f} GB from the "
                           f"device")
    print(f"  ssd: the page-cache eviction {took}; the cold read took "
          f"{t['ssd_warm'] / t['ssd']:.2f}x the warm re-read's time",
          flush=True)


def phase_j_attribution(fused: dict, n: int, e: int) -> None:
    """``modeled_time`` and ``attribution_report`` (``H100_MACHINE``) of
    phase D's kernel-fused depth-2 run: its ``Counters`` (the epoch and the
    ``initialize`` before it, which writes the layer-0 table),
    ``gnn_epoch_flops(n, e, DIMS)`` and its measured wall (one epoch +
    AdamW)."""
    from repro_torch.core.costmodel import (
        H100_MACHINE, gnn_epoch_flops, modeled_time,
    )
    from repro_torch.obs.attribution import (
        attribution_report, format_attribution,
    )

    c = fused["counters"]
    flops = gnn_epoch_flops(n, e, DIMS)
    wall = fused["wall_s"][-1]
    mt = modeled_time(c, H100_MACHINE, flops)
    print(f"  phase D kernel-fused depth 2, one epoch: measured wall "
          f"{wall:.3f} s; modeled (H100_MACHINE): storage "
          f"{mt.t_storage:.3f} s, link {mt.t_link:.3f} s, host "
          f"{mt.t_host:.3f} s, compute {mt.t_compute:.4f} s "
          f"({flops:.4g} FLOP); serial {mt.serial:.3f} s, overlapped "
          f"{mt.overlapped:.3f} s", flush=True)
    rep = attribution_report(c.snapshot(), H100_MACHINE, wall, flops=flops,
                             metrics=c.metrics.snapshot())
    print(format_attribution(rep), flush=True)
    check(rep["limiting_stage"] is not None,
          f"attribution's limiting stage: {rep['limiting_stage']} (modeled "
          f"{rep['modeled_s'][rep['limiting_stage']]:.3f} s of the "
          f"{wall:.3f} s wall)")


def phase_j_telemetry(dev) -> dict:
    """A pipelined GCN epoch at phase B's size under a ``TelemetryServer``
    on a free port: ``GET /metrics`` after it, parsed with
    ``parse_prometheus_text``, holds every byte counter of
    ``Counters.snapshot()``. Returns the run's launches."""
    import tempfile
    import urllib.request

    import torch

    from repro_torch.core.cache import HostCache
    from repro_torch.core.counters import Counters
    from repro_torch.core.engine import SSOEngine
    from repro_torch.core.storage import StorageTier
    from repro_torch.graph.synthetic import random_features, random_labels
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.infer import _smoke_graph
    from repro_torch.models.gnn.layers import get_gnn
    from repro_torch.obs.live import TelemetryServer, parse_prometheus_text
    from repro_torch.runtime import PipelineConfig

    g, plan = _smoke_graph(B_NODES, B_AVG_DEGREE, B_PARTS, dev)
    spec = get_gnn("gcn")
    X = random_features(g.n_nodes, B_DIMS[0], 0)[plan.ro.perm]
    Y = random_labels(g.n_nodes, B_DIMS[-1], 0)[plan.ro.perm]
    params = spec.init(torch.Generator().manual_seed(0), B_DIMS[0],
                       B_DIMS[1], B_DIMS[-1], len(B_DIMS) - 1, device=dev)
    c = Counters()
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    eng = SSOEngine(spec, plan, B_DIMS, st, HostCache(4 << 20, st, c), c,
                    pipeline=PipelineConfig(depth=2), device=dev)
    srv = TelemetryServer(c, port=0).start()
    try:
        reset_launches()          # this path's launches start here
        eng.initialize(X)
        eng.run_epoch(params, Y)
        launches = launch_counts()
        url = f"http://127.0.0.1:{srv.port}/metrics"
        with urllib.request.urlopen(url, timeout=30) as resp:
            body = resp.read().decode()
        snap = c.snapshot()
    finally:
        srv.stop()
        eng.close()
        st.close()
    scraped = parse_prometheus_text(body)
    fields = sorted(k for k in snap if k.endswith("_bytes"))
    bad = {k: (scraped.get(f"repro_counters_{k}"), snap[k]) for k in fields
           if scraped.get(f"repro_counters_{k}") != snap[k]}
    print(f"  telemetry: {len(scraped)} samples scraped from {url}; "
          f"launches {launches}", flush=True)
    check(not bad and snap["h2d_bytes"] > 0 and snap["storage_read_bytes"] > 0,
          f"GET /metrics after a pipelined GCN epoch ({B_NODES} nodes): its "
          f"{len(fields)} byte counters equal Counters.snapshot()'s "
          f"(h2d {snap['h2d_bytes']}, storage read "
          f"{snap['storage_read_bytes']}){'' if not bad else f'; {bad}'}")
    check(c.threads_leaked == 0, "telemetry: no thread leaked")
    return launches


def phase_j_ledger(dev) -> dict:
    """``python -m repro_torch.launch.train --arch gcn-cora --offload
    --ledger <tmp>``: exit 0 and one ``train_offload_smoke`` record that
    ``validate_record`` passes, with backend ``cuda``. Returns the run's
    launches."""
    import os
    import tempfile

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.train import main as train_main
    from repro_torch.obs.ledger import RunLedger, validate_record

    path = os.path.join(tempfile.mkdtemp(), "ledger.jsonl")
    reset_launches()              # this path's launches start here
    try:
        train_main(["--arch", "gcn-cora", "--offload", "--ledger", path])
        code = None
    except SystemExit as e:
        code = e.code
    launches = launch_counts()
    check(code == 0, f"launch.train gcn-cora --offload --ledger: exit {code}")
    recs = RunLedger(path).records()
    rec = recs[0] if recs else {}
    errs = validate_record(rec)
    check(len(recs) == 1 and not errs and rec["backend"] == "cuda"
          and rec["run_kind"] == "train_offload_smoke"
          and rec["watch"] == {"wall_s": "lower"},
          f"ledger: one train_offload_smoke record, valid {errs}, backend "
          f"{rec.get('backend')!r}, headline {rec.get('headline', {})}")
    os.remove(path)
    os.rmdir(os.path.dirname(path))
    return launches


def phase_j_example(dev) -> dict:
    """``examples.train_gnn_offload`` at its defaults: ``J_EXAMPLE_EPOCHS``
    epochs straight, then ``J_CKPT_EPOCH`` epochs with a checkpoint at the
    end and a second run that resumes from it: the resumed run's losses and
    final parameters equal the straight run's bitwise. Returns the launches
    of the three runs."""
    import shutil
    import tempfile

    import torch

    from repro_torch.examples import train_gnn_offload
    from repro_torch.kernels import launch_counts, reset_launches

    straight_dir, ck = tempfile.mkdtemp(), tempfile.mkdtemp()
    reset_launches()              # this path's launches start here
    t0 = time.perf_counter()
    try:
        a = train_gnn_offload.main(["--epochs", str(J_EXAMPLE_EPOCHS),
                                    "--ckpt", straight_dir])
        b = train_gnn_offload.main(["--epochs", str(J_CKPT_EPOCH),
                                    "--ckpt-every", str(J_CKPT_EPOCH),
                                    "--ckpt", ck])
        r = train_gnn_offload.main(["--epochs", str(J_EXAMPLE_EPOCHS),
                                    "--ckpt-every", str(J_CKPT_EPOCH),
                                    "--ckpt", ck])
    finally:
        shutil.rmtree(straight_dir, ignore_errors=True)
        shutil.rmtree(ck, ignore_errors=True)
    launches = launch_counts()
    print(f"  train_gnn_offload: {2 * J_EXAMPLE_EPOCHS} epochs in three runs "
          f"in {time.perf_counter() - t0:.1f} s; losses {a['losses']}; "
          f"launches {launches}", flush=True)
    check(all(math.isfinite(x) for x in a["losses"] + r["losses"])
          and len(b["checkpoints"]) == 1 and r["start"] == J_CKPT_EPOCH
          and b["losses"] == a["losses"][:J_CKPT_EPOCH]
          and r["losses"] == a["losses"][J_CKPT_EPOCH:]
          and all(torch.equal(x, y) for x, y in
                  zip(a["params"].parameters(), r["params"].parameters())),
          f"train_gnn_offload: checkpoint at epoch {J_CKPT_EPOCH}, resumed "
          f"run == straight run (losses and final parameters, bitwise)")
    return launches


def phase_j(g, fused: dict, smi: str, dev) -> dict:
    """Phase J; returns its launches, summed over its runs."""
    phase_j_microbatch(g, dev)
    phase_j_tiers(smi, dev)
    phase_j_attribution(fused, g.n_nodes, g.n_edges)
    launches = dict(NO_LAUNCHES)
    for run in (phase_j_telemetry, phase_j_ledger, phase_j_example):
        for k, v in run(dev).items():
            launches[k] += v
    return launches


# ----------------------------------------------------------------- phase H
def unit_norms(e, tol: float = 1e-5) -> bool:
    import torch

    return bool(torch.isfinite(e).all()) and bool(
        ((torch.linalg.vector_norm(e, dim=-1) - 1).abs() <= tol).all())


def pct(lat_s, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(lat_s) * 1e3, q))


def phase_h_serving(dev):
    import numpy as np
    import torch

    from repro_torch.configs.base import RECSYS_SHAPES, recsys_model_flops
    from repro_torch.configs.two_tower_retrieval import CONFIG as cfg
    from repro_torch.examples.serve_retrieval import (
        BULK, build_corpus, query_latencies,
    )
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.recsys.two_tower import (
        init_two_tower, score_candidates, serve_user_tower,
    )

    print(f"phase H: two-tower serving at {cfg.name} widths, "
          f"{cfg.user_vocab} + {cfg.item_vocab} table rows", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_two_tower(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * 4 for p in model.parameters())
    print(f"  model: {n_bytes / 1e9:.2f} GB of weights, made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(1)

    def users(b):
        return torch.from_numpy(rng.integers(
            0, cfg.user_vocab, (b, cfg.n_user_fields, cfg.bag_size)
        ).astype(np.int32)).to(dev)

    # a comparison, outside the counted run: kernel == reference bitwise
    u = users(RECSYS_SHAPES["serve_p99"]["batch"])
    k = serve_user_tower(model, u, cfg, "kernel")
    r = serve_user_tower(model, u, cfg, "reference")
    check(torch.equal(k, r), f"serve_p99 batch: kernel == reference "
          f"(bitwise, {tuple(k.shape)})")
    del k, r

    reset_launches()          # this path's launches start here
    bags = 0
    # serve_p99: ids on the card before the clock, each call synchronised
    B, warm, n_q = RECSYS_SHAPES["serve_p99"]["batch"], 5, 50
    lat = []
    for _ in range(warm + n_q):
        u = users(B)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = serve_user_tower(model, u, cfg)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    bags += warm + n_q
    p99_ids = u
    check(unit_norms(e), f"serve_p99: finite, unit norms within 1e-5 "
          f"({tuple(e.shape)})")
    p99_p50, p99_p99 = pct(lat[warm:], 50), pct(lat[warm:], 99)
    print(f"  serve_p99 (batch {B}, {n_q} queries): p50 {p99_p50:.4f} ms, "
          f"p99 {p99_p99:.4f} ms", flush=True)

    # serve_bulk
    B = RECSYS_SHAPES["serve_bulk"]["batch"]
    u = users(B)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = serve_user_tower(model, u, cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    bags += 3
    check(unit_norms(e), f"serve_bulk: finite, unit norms within 1e-5 "
          f"({tuple(e.shape)})")
    wall = min(walls)
    lookups = B * cfg.n_user_fields * cfg.bag_size
    print(f"  serve_bulk (batch {B}): walls "
          f"{', '.join(f'{w * 1e3:.3f}' for w in walls)} ms; "
          f"{lookups / wall:.4e} lookups/s, "
          f"{recsys_model_flops(cfg, 'serve', B) / wall / 1e12:.2f} TFLOP/s "
          f"(best)", flush=True)
    bulk_ids = u
    del e

    # retrieval_cand: the corpus through the item tower in bulk chunks
    n_cand = RECSYS_SHAPES["retrieval_cand"]["n_candidates"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corpus = build_corpus(model, cfg, n_cand, np.random.default_rng(2), dev,
                          bulk=BULK)
    torch.cuda.synchronize()
    t_corpus = time.perf_counter() - t0
    bags += math.ceil(n_cand / BULK)
    check(unit_norms(corpus), f"corpus: finite, unit norms within 1e-5 "
          f"({tuple(corpus.shape)}, built in {t_corpus:.3f} s)")
    warm, n_q = 2, 30
    lat, vals, idx = query_latencies(model, cfg, corpus, rng, dev,
                                     n_queries=warm + n_q, batch=1,
                                     top_k=128)
    bags += warm + n_q
    u = users(1)
    vals, idx = score_candidates(model, u, corpus, cfg, top_k=128)
    full = serve_user_tower(model, u, cfg) @ corpus.T
    bags += 2
    check(bool(torch.isfinite(vals).all()) and int(idx[0, 0]) == int(
        full.argmax()) and bool((vals[0, 1:] <= vals[0, :-1]).all()),
        "retrieval_cand: top-1 == argmax of the full score row, top-128 "
        "sorted descending, finite")
    print(f"  retrieval_cand ({n_cand} candidates, batch 1, top-128, {n_q} "
          f"queries): p50 {pct(lat[warm:], 50):.4f} ms, p99 "
          f"{pct(lat[warm:], 99):.4f} ms; corpus built in "
          f"{t_corpus * 1e3:.1f} ms; peak device "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    counts = launch_counts()
    check(counts == dict(NO_LAUNCHES, embedding_bag=bags),
          f"serving launches {counts} == {bags} embedding_bag (one per "
          f"tower call)")
    del corpus, full
    # the bag kernel at each serving shape, after the counted run: the
    # corpus's first chunk is build_corpus's first draw from seed 2
    chunk_ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.item_vocab, (BULK, cfg.n_item_fields, cfg.bag_size)
    ).astype(np.int32)).to(dev)
    rows = [bag_shape("serve_p99", model.user_table, p99_ids, 5 + 50),
            bag_shape("serve_bulk", model.user_table, bulk_ids, 3),
            bag_shape("corpus chunk", model.item_table, chunk_ids,
                      math.ceil(n_cand / BULK)),
            bag_shape("retrieval query", model.user_table, u, 2 + 30 + 2)]
    del model, p99_ids, bulk_ids, chunk_ids, u
    torch.cuda.empty_cache()
    return counts, rows


def phase_h_training(dev):
    import dataclasses
    import shutil
    import tempfile

    import torch

    from repro_torch.configs.base import recsys_model_flops
    from repro_torch.configs.two_tower_retrieval import CONFIG
    from repro_torch.examples.train_two_tower import (
        make_batch_fn, make_config, make_step_fn,
    )
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.recsys.two_tower import (
        init_two_tower, two_tower_value_and_grad,
    )
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.train import LoopConfig, run_training_loop

    cfg = dataclasses.replace(CONFIG, user_vocab=H_TRAIN_VOCAB,
                              item_vocab=H_TRAIN_VOCAB)
    B = H_TRAIN_BATCH
    print(f"phase H: two-tower training at {cfg.name} widths, "
          f"{H_TRAIN_VOCAB} rows per table, batch {B}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    model = init_two_tower(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    batch_fn = make_batch_fn(cfg, B, H_TRAIN_VOCAB, dev)

    # a comparison, outside the counted run: the first step's loss and
    # every gradient, kernel == reference
    u, i = batch_fn(0)
    (lk, _), gk = two_tower_value_and_grad(model, u, i, cfg, "kernel")
    (lr_, _), gr = two_tower_value_and_grad(model, u, i, cfg, "reference")
    check(torch.equal(lk, lr_) and all(torch.equal(gk[n], gr[n]) for n in gk),
          f"step 0: kernel == reference (loss {float(lk)!r} and "
          f"{len(gk)} gradients, bitwise)")
    del gk, gr, u, i

    step_fn = make_step_fn(cfg)
    walls = []

    def timed_step(p, o, batch):
        t0 = time.perf_counter()
        out = step_fn(p, o, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out

    log = lambda m: print(f"    {m}", flush=True)
    reset_launches()          # this path's launches start here
    params, opt, state = run_training_loop(
        LoopConfig(total_steps=H_TRAIN_STEPS, log_every=5), model,
        adamw_init(model), timed_step, batch_fn, log_fn=log)
    counts = launch_counts()
    losses = state.losses
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{H_TRAIN_STEPS} steps: losses finite and falling "
          f"({losses[0]!r} -> {losses[-1]!r})")
    per_step = 2 * H_TRAIN_STEPS
    check(counts == dict(NO_LAUNCHES, embedding_bag=per_step,
                         scatter_add=per_step),
          f"training launches {counts}: 2 embedding_bag and 2 scatter_add "
          f"per step")
    steady = sorted(walls[1:])[len(walls[1:]) // 2]
    print(f"  step walls ms: {', '.join(f'{w * 1e3:.1f}' for w in walls)}; "
          f"median after the first {steady * 1e3:.3f} ms, "
          f"{recsys_model_flops(cfg, 'train', B) / steady / 1e12:.2f} "
          f"TFLOP/s; peak device "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    # where a step's time goes: one more step, its gradients and its
    # AdamW update timed apart (after the counted run)
    u, i = batch_fn(H_TRAIN_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = two_tower_value_and_grad(params, u, i, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(grads, params, opt, lr=1e-3)
    torch.cuda.synchronize()
    print(f"  one more step: loss and gradients {(t1 - t0) * 1e3:.3f} ms, "
          f"AdamW {(time.perf_counter() - t1) * 1e3:.3f} ms", flush=True)
    del grads
    rows = [bag_shape("training user", params.user_table, u, H_TRAIN_STEPS),
            bag_shape("training item", params.item_table, i, H_TRAIN_STEPS)]
    del model, params, opt, state, i
    torch.cuda.empty_cache()
    phase_h_scatter(u, cfg, dev)
    del u

    # checkpoint resume at the example's own size
    ecfg = make_config(H_RESUME_VOCAB)
    ebatch = make_batch_fn(ecfg, H_RESUME_BATCH, H_RESUME_VOCAB, dev)
    estep = make_step_fn(ecfg)

    def loop(ckpt, steps):
        p = init_two_tower(ecfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
        return run_training_loop(
            LoopConfig(total_steps=steps, ckpt_dir=ckpt, ckpt_every=10,
                       log_every=10), p, adamw_init(p), estep, ebatch,
            log_fn=log)

    reset_launches()
    ref_p, _, ref_s = loop(None, 20)
    ckpt = tempfile.mkdtemp()
    try:
        loop(ckpt, 10)
        got_p, _, got_s = loop(ckpt, 20)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    resume_counts = launch_counts()
    check(got_s.losses == ref_s.losses[10:] and all(
        torch.equal(a, b) for a, b in zip(got_p.parameters(),
                                          ref_p.parameters())),
          f"resumed at step 10 ({H_RESUME_VOCAB} rows, batch "
          f"{H_RESUME_BATCH}): losses and final parameters == 20 straight "
          f"steps (bitwise)")
    check(resume_counts == dict(NO_LAUNCHES, embedding_bag=80,
                                scatter_add=80),
          f"resume launches {resume_counts}: 2 + 2 per step over 40 steps")
    eu, ei = ebatch(0)
    rows += [bag_shape("resume user", ref_p.user_table, eu, 40),
             bag_shape("resume item", ref_p.item_table, ei, 40)]
    del ref_p, got_p, eu, ei
    torch.cuda.empty_cache()
    return {k: counts[k] + resume_counts[k] for k in counts}, rows


def phase_h_scatter(user_ids, cfg, dev) -> None:
    """The user table gradient's write-back at a training batch's shape
    (every lookup's value row, sorted by row; the example's users repeat
    one id over all 128 slots): ``scatter_add_`` bitwise vs its plain
    version, with times. Printed only (phase A's ``scatter_add`` row stays
    at phase D's shape)."""
    import torch

    from repro_torch.kernels.gather_scatter import ops, ref

    rows, _ = torch.sort(user_ids.reshape(-1), stable=True)
    R, D = rows.numel(), cfg.embed_dim
    gen = torch.Generator(device=dev).manual_seed(3)
    values = torch.randn((R, D), generator=gen, device=dev)
    base = torch.zeros((cfg.user_vocab, D), device=dev)
    k = ops.scatter_add_(base.clone(), rows, values)
    p = ref.scatter_add_ref(base.clone(), rows, values)
    torch.cuda.synchronize()
    U = int(torch.unique(rows).numel())
    check(torch.equal(k, p), f"scatter_add bitwise vs plain at the user "
          f"table gradient ({cfg.user_vocab} x {D}, {R} value rows, {U} "
          f"distinct)")
    del k, p
    b_ms, b_by = bound(R * D * 4 + 2 * U * D * 4 + 4 * R, float(R * D))
    kb, pb = base.clone(), base.clone()
    print(f"  scatter_add at the user table gradient: kernel "
          f"{time_ms(lambda: ops.scatter_add_(kb, rows, values)):.4f} ms, "
          f"plain {time_ms(lambda: ref.scatter_add_ref(pb, rows, values)):.4f}"
          f" ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
    del kb, pb, base, values
    torch.cuda.empty_cache()


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
    from repro_torch.launch.train import (
        DENSE_GRAD_TOL, DENSE_LOSS_TOL, _train_smoke, dense_ok,
    )
    from repro_torch.models.gnn.layers import get_gnn
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.runtime import PipelineConfig
    from repro_torch.train import EpochLoopConfig, run_epoch_loop

    print(f"phase E: {E_NODES} nodes at widths {DIMS} vs a dense autograd "
          f"oracle; checkpointed epoch loop with a resume", flush=True)
    for model in ("gcn", "gat"):
        serial = {}
        for mode in MODES:
            r = _train_smoke(
                model, 2, dims=DIMS, n_nodes=E_NODES, n_parts=E_PARTS,
                avg_degree=AVG_DEGREE, cache_mb=E_CACHE_MB, kernels=mode,
                dense_check=True, device=dev,
            )
            check(r["finite"] and r["pipeline_matches_serial"],
                  f"{model} {mode}: finite, pipelined == serial (bitwise)")
            check(dense_ok(r),
                  f"{model} {mode}: loss within {DENSE_LOSS_TOL} and "
                  f"gradients within {DENSE_GRAD_TOL} ({dense_report(r)})")
            serial[mode] = r["runs"][0]
            del r
            torch.cuda.empty_cache()
        ker, ref = serial["kernel"], serial["reference"]
        check(ker["losses"] == ref["losses"]
              and all(torch.equal(a[k], b[k])
                      for a, b in zip(ker["grads"][0], ref["grads"][0])
                      for k in a),
              f"{model}: kernel == reference (loss and every gradient, "
              f"bitwise)")
        del serial, ker, ref

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


# ----------------------------------------------------------------- phase I
def phase_i(dev) -> dict:
    """Phi-3-medium-14B serving at ``CONFIG`` widths (40 layers, d_model
    5120, 40 query and 10 KV heads of 128, d_ff 17,920, vocab 100,352,
    bf16), weights from a ``torch.Generator`` seeded 0 on the card, tokens
    from numpy seeds. Returns each kernel's launches over its runs."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.phi3_medium_14b import CONFIG as cfg
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.train import _lm_decode, _lm_prefill
    from repro_torch.models.lm.steps import make_prefill_step
    from repro_torch.models.lm.transformer import init_lm_params

    L = cfg.n_layers
    print(f"phase I: {cfg.name} serving at its published widths "
          f"({L} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.d_head}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, {cfg.dtype})", flush=True)
    t0 = time.perf_counter()
    model = init_lm_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    # param_count() leaves the final norm out, as the reference's does
    check(n_params == cfg.param_count() + cfg.d_model
          and cfg.param_count() == 14_659_502_080,
          f"{n_params} parameters == param_count() 14,659,502,080 + the "
          f"final norm ({2 * n_params / 1e9:.2f} GB in bf16; made in "
          f"{time.perf_counter() - t0:.1f} s)")
    counts = dict(NO_LAUNCHES)

    def tally(want_flash: int, what: str) -> None:
        n = launch_counts()
        check(n == dict(NO_LAUNCHES, flash_attention=want_flash),
              f"{what}: launches {n} == {want_flash} flash_attention")
        for k, v in n.items():
            counts[k] += v

    # 1. the kernel route against the plain chunked_attention, full depth
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, CHECK_SEQ)).astype(np.int32)).to(dev)
    logits = {}
    for mode in ("kernel", "reference"):
        reset_launches()
        t0 = time.perf_counter()
        logits[mode] = make_prefill_step(cfg, mode, dev)(model, toks)
        torch.cuda.synchronize()
        print(f"  prefill {mode} at {CHECK_SEQ} tokens: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        tally(L if mode == "kernel" else 0, f"prefill {mode} at "
              f"{CHECK_SEQ} tokens")
    err = rel_err(logits["reference"].cpu().numpy(),
                  logits["kernel"].cpu().numpy())
    check(bool(torch.isfinite(logits["kernel"]).all()) and
          err <= LM_KERNEL_TOL,
          f"prefill at {CHECK_SEQ} tokens, {L} layers: kernel's last "
          f"logits within {LM_KERNEL_TOL} max-relative of reference's "
          f"({err:.3e})")
    del logits, toks

    # 2. prefill_32k at batch 1 (cut from 32)
    reset_launches()
    r = _lm_prefill(model, PREFILL_BATCH, PREFILL_SEQ, "kernel",
                    warmup_seq=PREFILL_WARMUP_SEQ)
    tally(2 * L, f"prefill_32k (warm-up at {PREFILL_WARMUP_SEQ} + timed)")
    check(r["launches"] == L and r["finite"],
          f"prefill_32k: {r['launches']} flash_attention launches in the "
          f"timed call == {L}, finite last logits {tuple(r['logits'].shape)}")
    print(f"  prefill_32k (batch {PREFILL_BATCH}, {PREFILL_SEQ} tokens): "
          f"wall {r['wall_s']:.3f} s, {r['tokens_per_s']:.1f} tokens/s, "
          f"{r['tflops']:.2f} TFLOP/s, peak device {r['peak_gb']:.2f} GB",
          flush=True)
    out = dict(prefill=r)
    del r["logits"]
    torch.cuda.empty_cache()

    # 3. decode_32k at batch 4 (cut from 128) against a 32k cache
    reset_launches()
    d = _lm_decode(model, DECODE_BATCH, DECODE_SEQ, DECODE_STEPS)
    tally(0, "decode_32k")
    check(d["finite"], f"decode_32k: {DECODE_STEPS} steps' logits finite")
    cache_gb = 2.0 * L * DECODE_BATCH * DECODE_SEQ * cfg.n_kv_heads \
        * cfg.d_head * 2 / 1e9
    bound_ms = (2.0 * n_params / 1e9 + cache_gb) / HBM_BYTES_PER_S * 1e12
    print(f"  decode_32k (batch {DECODE_BATCH}, cache {DECODE_SEQ} "
          f"positions, {cache_gb:.2f} GB, filled to {DECODE_FILL}): p50 "
          f"{d['p50_ms']:.3f} ms, p99 {d['p99_ms']:.3f} ms a step, "
          f"{d['tokens_per_s']:.1f} tokens/s, {d['tflops']:.3f} TFLOP/s, "
          f"peak device {d['peak_gb']:.2f} GB; bound (weights + cache at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s) {bound_ms:.3f} ms", flush=True)
    out["decode"] = d
    del d
    torch.cuda.empty_cache()

    # 4. decode == prefill: a prompt decoded token by token, full width
    roundtrip(model, LM_ROUNDTRIP_TOL, tally)
    del model
    torch.cuda.empty_cache()

    # 5. the same two checks in float32 at the same widths, 2 layers
    f32 = dataclasses.replace(cfg, dtype=torch.float32,
                              n_layers=LM_F32_LAYERS)
    model = init_lm_params(f32, torch.Generator(dev).manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, CHECK_SEQ)).astype(np.int32)).to(dev)
    reset_launches()
    a, b = (make_prefill_step(f32, mode, dev)(model, toks)
            for mode in ("kernel", "reference"))
    tally(LM_F32_LAYERS, f"float32 prefill at {CHECK_SEQ} tokens")
    err = rel_err(b.cpu().numpy(), a.cpu().numpy())
    check(err <= LM_F32_TOL,
          f"float32, {LM_F32_LAYERS} layers: prefill kernel within "
          f"{LM_F32_TOL} max-relative of reference ({err:.3e})")
    roundtrip(model, LM_F32_TOL, tally)
    del model, a, b, toks
    torch.cuda.empty_cache()
    out["launches"] = counts
    return out


def roundtrip(model, tol: float, tally) -> None:
    """A prompt of ``ROUNDTRIP_SEQ`` tokens (numpy seed 1) decoded token by
    token against ``lm_forward`` on the same tokens in kernel mode: the
    logits within ``tol`` max-relative."""
    import numpy as np
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.models.lm.steps import make_decode_step
    from repro_torch.models.lm.transformer import init_kv_cache, lm_forward

    cfg, dev = model.cfg, model.device
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, ROUNDTRIP_SEQ)).astype(np.int32)).to(dev)
    reset_launches()
    with torch.no_grad():
        full, _ = lm_forward(model, toks, "kernel")
    cache = init_kv_cache(cfg, 1, ROUNDTRIP_SEQ, device=dev)
    step = make_decode_step(cfg, "kernel", dev)
    dec = []
    for t in range(ROUNDTRIP_SEQ):
        lg, cache = step(model, cache, toks[:, t:t + 1], t + 1)
        dec.append(lg)
    dec = torch.stack(dec, dim=1)
    torch.cuda.synchronize()
    tally(cfg.n_layers, f"{cfg.dtype} decode == prefill at {ROUNDTRIP_SEQ} "
          f"tokens")
    rt = rel_err(full.cpu().numpy(), dec.cpu().numpy())
    check(bool(torch.isfinite(dec).all()) and rt <= tol,
          f"{cfg.dtype}, {cfg.n_layers} layers: {ROUNDTRIP_SEQ} tokens "
          f"decoded one at a time == lm_forward (kernel) within {tol} "
          f"max-relative ({rt:.3e}; the reference's float32 figure is 2e-5)")


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
    # one nvcc per source, all started together (each package has its own
    # build lock)
    with ThreadPoolExecutor(len(KERNEL_PACKAGES)) as ex:
        list(ex.map(_build.load, KERNEL_PACKAGES))
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for pkg in KERNEL_PACKAGES:
        print(_build.build_log(pkg).strip(), flush=True)
    n = hgmma_count(_build)
    check(n > 0, f"flash_attention's bf16 kernel (flash_fwd_wgmma) has {n} "
          f"HGMMA instructions in its SASS: it runs on the tensor cores")

    t_all = time.perf_counter()
    # B and C first: the launcher keeps one graph, so the full-width one is
    # then built once for A, D, F and G
    phase_b(dev)
    t0 = time.perf_counter()
    serving = phase_c(dev)
    print(f"phase C: {time.perf_counter() - t0:.1f} s", flush=True)
    # the bsr_spmm row while phase C's graph is still the launcher's cached
    # one (build_full_width replaces it)
    t0 = time.perf_counter()
    bsr_row, bsr_launches = phase_a_bsr(dev)
    print(f"phase A (bsr_spmm): {time.perf_counter() - t0:.1f} s", flush=True)
    plan = build_full_width(dev)
    # D's graph itself, for phase J (the launcher's cached entry: phase G
    # replaces it)
    from repro_torch.launch.infer import _smoke_graph
    graph, _ = _smoke_graph(N_NODES, AVG_DEGREE, N_PARTS, dev)
    results = phase_a(plan, DIMS[0], dev)
    results["bsr_spmm"] = bsr_row
    t0 = time.perf_counter()
    training, fused_run = phase_d(plan, dev)
    print(f"phase D: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    gat = phase_f(plan, dev)
    print(f"phase F: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    families = phase_g(dev)
    print(f"phase G: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    baseline = phase_j(graph, fused_run, smi, dev)
    print(f"phase J: {time.perf_counter() - t0:.1f} s", flush=True)
    del plan, graph, fused_run
    t0 = time.perf_counter()
    phase_e(dev)
    print(f"phase E: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    tt_serving, bag_rows = phase_h_serving(dev)
    tt_training, rows = phase_h_training(dev)
    bag_shapes_summary(bag_rows + rows)
    print(f"phase H: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    lm = phase_i(dev)
    print(f"phase I: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"all phases: {time.perf_counter() - t_all:.1f} s", flush=True)

    kernels = []
    for name, r in results.items():
        # each kernel's launches over the serving, GCN training, GAT
        # training, other families' training, phase J's runs, two-tower
        # serving and training, LM serving and bsr_spmm aggregate paths,
        # every count read right after its runs
        n = sum(serving[m][name] + training[m][name] for m in MODES)
        n += sum(counts[name] for counts in gat.values())
        n += sum(counts[name] for counts in families.values())
        n += baseline[name]
        n += tt_serving[name] + tt_training[name] + lm["launches"][name]
        n += bsr_launches if name == "bsr_spmm" else 0
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE[name],
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
