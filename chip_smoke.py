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
  and deterministic on a rerun, then at that shape in place in a
  page-locked host base as the engine runs it (``scatter_add_host_``, one
  launch, bitwise the plain version; its row's bound is the host link's,
  each touched row once each way at the measured rate); ``segment_sum`` at
  unit 0 of the benchmark graph's plan (``perfbench/rmat.py``, 524,288
  edge rows of 1,024 into 8,192 destinations, row 0 holding the padded
  tail) bitwise its plain version and a rerun, and ``index_put_(accumulate=
  True)`` on every segment of at most ``SEGMENT_CHUNK`` edges, with
  ``index_put_`` as its library time; ``edge_softmax`` within ``(deg + 4 + |s -
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
  storage, and each mode's own launch counts: none of the TPU table's in
  reference, one ``gather_rows`` per unit and layer in kernel, one
  ``gather_aggregate`` per unit and layer in kernel-fused; one
  ``segment_sum`` (the aggregate) per unit with edges and layer in
  reference and kernel, none in kernel-fused.
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
  count in kernel-fused; in both kernel modes every one of those pairs
  added in place in a page-locked grad buffer and none through a round
  trip (``Counters.scatter_inplace_pairs`` / ``scatter_copy_pairs``);
  ``segment_sum`` three times per (run, layer, unit with edges) in
  reference and kernel (the forward's aggregate, the backward's recompute
  of it, the edge gather's transpose), twice in kernel-fused (its forward
  is ``gather_aggregate``).
- Phase F, GAT training at full width: the same graph, widths and cache
  (hidden layers 4 heads of 64, the output layer one head of 19), one epoch
  + AdamW in modes reference and kernel-fused at depth 0 and 2. Checks
  finite loss and gradients, pipelined == serial bitwise, kernel-fused
  within 1e-4 (loss) and 5e-4 (gradients) of reference, and exact launch
  counts: ``edge_softmax`` once per (run, forward or backward pass, layer,
  unit with edges), ``gather_rows`` once per (run, pass, layer, unit) and
  phase D's ``scatter_add`` count in kernel-fused; none of the TPU
  table's in reference; ``segment_sum`` ten times per (run, layer, unit
  with edges) in reference, seven in kernel-fused (``edge_softmax`` takes
  the softmax's sums in the forward and the recompute; its vjp sums once).
- Phase G, the other families' training at full width: ``sage``,
  ``gin``, ``pna`` and ``graphcast`` at the same widths on a 65,536-node
  graph with a 128 MB host cache (cut from D's 262,144 nodes and 512 MB,
  the same share of the layer-0 table, to keep the script inside its time
  limit), one epoch + AdamW in kernel mode at depth 0 and 2. Checks finite
  loss and gradients, pipelined == serial bitwise, and exact launch
  counts: ``gather_rows`` once per (run, pass, layer, unit), the
  ``scatter_add`` count of this graph's grad write-backs, and
  ``segment_sum`` per (run, layer, unit with edges) 4 times in ``sage``
  and ``gin``, 6 in ``pna`` and 5 in ``graphcast``.
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
  machine's disk is no fault of the code); (3) ``modeled_time`` of phase D's
  kernel-fused depth-2 run (its epoch's counters, ``gnn_epoch_flops``)
  printed beside its measured wall; (4) a pipelined GCN epoch at
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

- Phase L, dense-LM training: (1) ``phi3-medium-14b`` ``train_4k`` at
  its published widths (d_model 5120, 40 / 10 heads of 128, d_ff 17,920,
  vocab 100,352, bf16, 4,096 tokens) cut to ``L_LAYERS`` layers and batch
  ``L_BATCH`` (from 40 and 256), ``L_STEPS`` steps of ``make_train_step``
  (AdamW in place) on one batch through the launcher's ``_lm_train``:
  every loss, ``m`` and ``v`` finite, the loss falling, no kernel launch
  (training attends through ``chunked_attention``); prints each step's
  loss, wall, tokens/s and TFLOP/s, the peak device GB beside
  ``lm_cell_bytes``' reckoning; (2) remat on vs off at the same widths,
  ``L_REMAT_LAYERS`` layers, batch 1: the loss and every gradient
  bitwise, and the checkpointed ``chunked_attention``'s q, k, v gradients within
  ``L_ATTN_TOL`` of plain autograd's in float32; (3) each dense id's
  ``SMOKE``: ``lm_loss``, its gradients and one in-place AdamW step on the
  card and the CPU within ``L_CPU_TOL``; (4) ``command-r-plus-104b``
  (groups of 12) and ``deepseek-67b`` (groups of 8) at ``CONFIG`` widths,
  ``L_FLASH_LAYERS`` layers: a ``CHECK_SEQ``-token prefill, kernel within
  ``LM_KERNEL_TOL`` of reference, exactly ``L_FLASH_LAYERS``
  ``flash_attention`` launches each (counted in the kernel line), and
  the wrapper at each id's prefill shape against the plain version as
  phase A holds it (those launches not counted). The
  three ids' ``smoke()`` run in phase K's registry pass.

- Phase M, MoE and MLA: (1) ``mixtral-8x7b`` at ``CONFIG`` widths (d_model
  4096, 32 / 8 heads of 128, window 4,096, 8 experts of 14,336 top-2,
  vocab 32,000, bf16) cut to ``M_LAYERS`` layers: kernel vs reference
  prefill at ``CHECK_SEQ`` tokens within ``M_KERNEL_TOL`` (one
  ``flash_attention`` launch a layer, none in reference), ``prefill_32k``
  at batch 1 and ``decode_32k`` at batch 4 through the launcher, with
  walls, peak GB beside ``lm_cell_bytes``, and the decode's all-expert
  and active-expert bounds, then decode == prefill at 64 tokens over every
  position within ``M_ROUNDTRIP_TOL`` (in bf16 the decode can route a
  near-tie token to other experts: the flips are printed with their
  margins and the decode is rerun fed the forward's experts); (2) the
  flash wrapper at Mixtral's windowed shape against its plain version at
  ``M_FLASH_CHECK_SEQ`` and at ``PREFILL_SEQ`` tokens, timed at the
  latter beside causal, SDPA with the window's mask and the bound (not
  counted); (3) at ``M_SMALL_LAYERS`` layers: ``long_500k`` (batch 1, a
  524,288-position cache) finite, ``train_4k`` at batch
  ``M_TRAIN_BATCH`` with the loss falling and no kernel launch, and the
  kernel check and roundtrip in float32 within ``LM_F32_TOL``, no routing
  flip allowed; remat on vs off at one layer bitwise; (4)
  ``deepseek-v2-236b`` at ``CONFIG`` widths (MLA, 160 experts top-6 + 2
  shared, a dense first layer) cut to ``DS_LAYERS`` layers: its real
  parameters counted, ``prefill_32k`` (no flash launch: MLA attends
  through ``chunked_attention``), ``decode_32k``, the bf16 roundtrip
  within ``DS_ROUNDTRIP_TOL`` and the float32 one at 2 layers within
  ``LM_F32_TOL``; (5) both MoE ``SMOKE``s card vs CPU within
  ``L_CPU_TOL``, with the router's smallest top-k margin.

- Phase K, the registry and ``distributed/``, in a process group of one
  rank (``nccl``, a file store; a ``gloo`` group beside it for the CPU
  runs) over a ``(1, 1)`` ``("data", "model")`` mesh, with the caching
  allocator's expandable segments on: (1) every registered arch's
  ``smoke()`` on the card (the five LMs' ``lm_loss`` and gradients
  included), finite with ``grad_norm > 0`` (the two-tower one also
  kernel == reference bitwise, with its launches), and ``list_cells()``'s
  40 assigned cells of 11 archs; (2) ``graphsage-reddit`` x
  ``ogb_products`` through the registry's CAGNET build at the cell's full
  size (2,449,029 nodes, 61,859,140 R-MAT edges made on the card from a
  seeded generator with
  ``kronecker_graph``'s quadrant law, widths [100, 128, 47], per-layer
  remat): 3 steps with walls and peak device GB, step 1's loss within
  1e-5 relative of ``full_graph_loss`` on the same inputs; (3) the MFG
  step at ``minibatch_lg``'s hop sizes (a fan-out of sources per seed,
  602 features) and the batched step at ``molecule`` (``pna``, 128 graphs
  of 30 nodes), 3 steps each, finite; (4) the partitioned-halo step (one
  partition of a 4,096-node graph) against ``full_graph_loss`` of the
  reordered graph within 1e-5, and split-KV decoding (window None and 16)
  within 1e-5 of the plain decode; (5) the CAGNET, MFG and batched steps
  on the card (nccl) and on the CPU (gloo) from the same inputs: losses
  within 1e-4 relative and AdamW's ``m`` within 1e-4 max-relative a leaf;
  and no kernel of the TPU table launched by the distributed steps (they
  run the layers' segment ops, whose sums on the card are ``segment_sum``).
- Phase N, the dry run (``launch/dryrun.py``) held against steps the card
  runs, at most 60 s: (1) ``graphsage-reddit`` x ``ogb_products`` traced
  for the card on a placeholder ``(1, 1)`` mesh: its predicted argument
  bytes exactly the bytes of the arguments phase K built, its predicted
  peak printed beside phase K's; (2) ``mixtral-8x7b`` x ``long_500k`` at
  2 layers the same way, against one real decode step on the card (the
  same model and a 524,288-position cache): argument bytes exactly, the
  trace's FLOPs exactly ``FlopCounterMode``'s count of the real step,
  the peaks side by side; (3) ``python -m repro_torch.launch.dryrun`` in
  two processes of their own on the 16 x 16 production mesh of 256
  placeholder ranks, one GNN cell and one LM cell, each ending ``ok``,
  their report lines printed; the card's name and power limit beside the
  roofline's datasheet constants and phase J's measured HBM rate.

Any failed check exits non-zero; no phase's failure is caught. TF32 is off
for matmuls and cuDNN (float32 means float32 here). The last line is the
JSON device record; the line before it the per-kernel JSON record.
"""
from __future__ import annotations

import json
import math
import os
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
    "segment_sum": GS_SOURCE,
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
    # the JAX package leaves its segment sums to XLA; every seg_sum on the
    # card runs this one
    "segment_sum": None,
}
KERNEL_PACKAGES = ("gather_scatter", "edge_softmax", "embedding_bag",
                   "flash_attention", "bsr_spmm")
TABLE = tuple(k for k, v in REPLACES.items() if v)   # the TPU table's kernels
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
# phase G: the same widths on a quarter of D's nodes, the host cache cut
# with them (a share of the layer-0 table as in D), to keep the script
# inside its time limit
G_NODES = 65536
G_CACHE_MB = 128
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
# phase L: phi3-medium-14b train_4k at its published widths, cut in depth
# (40 -> L_LAYERS) and batch (256 -> L_BATCH) to fit one card (PERF.md
# §4: about 46 GB reckoned), L_STEPS steps on one batch; remat on vs off
# at L_REMAT_LAYERS layers, batch 1; the flash kernel at the other two
# dense ids' widths, L_FLASH_LAYERS layers, a CHECK_SEQ-token prefill
L_LAYERS = 4
L_BATCH = 2
L_SEQ = 4096
L_STEPS = 3
L_REMAT_LAYERS = 2
L_FLASH_LAYERS = 2
# the checkpointed chunked_attention's q, k, v gradients against plain
# autograd's, float32, max-relative
L_ATTN_TOL = 1e-6
# card against CPU at each dense id's SMOKE, max-relative
L_CPU_TOL = 1e-4
# phase M: MoE and MLA. mixtral-8x7b at CONFIG widths cut in depth (32 ->
# M_LAYERS: 11.87 B parameters, 23.7 GB in bf16; 32 layers need 93 GB);
# long_500k and train_4k at M_SMALL_LAYERS (train_4k's batch cut 256 ->
# M_TRAIN_BATCH), remat on vs off at one layer; the windowed flash shape
# held against plain at M_FLASH_CHECK_SEQ tokens, where the window cuts,
# and at PREFILL_SEQ, where it is timed. deepseek-v2-236b cut 60 -> DS_LAYERS (the
# dense first layer and two MoE ones: 9.33 B real parameters, 18.7 GB)
M_LAYERS = 8
M_SMALL_LAYERS = 2
M_LONG_SEQ = 524288
M_LONG_STEPS = 8
M_TRAIN_BATCH = 2
M_FLASH_CHECK_SEQ = 8192
DS_LAYERS = 3
DS_PARAMS = 9_330_795_520      # its real leaves at DS_LAYERS
# phase M's bf16 tolerances (max |a - b| / max |a| of the logits), 2.5x
# the card's first readings (PERF.md §5): Mixtral's kernel vs reference
# prefill at CHECK_SEQ tokens (2.117e-02), and decode vs prefill over all
# ROUNDTRIP_SEQ positions with the decode fed the forward's experts:
# Mixtral's (2.988e-02) and DeepSeek-V2's at DS_LAYERS, the absorbed MLA
# decode against the materialised prefill (3.606e-02)
M_KERNEL_TOL = 5.3e-2
M_ROUNDTRIP_TOL = 7.5e-2
DS_ROUNDTRIP_TOL = 9.0e-2
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
    results["segment_sum"] = phase_a_segment_sum(dev)
    results["edge_softmax"] = phase_a_softmax(u, dev)
    results["embedding_bag"] = phase_a_bag(dev)
    results["flash_attention"] = phase_a_flash(dev)
    for name, r in results.items():
        print_row(name, r)
    torch.cuda.empty_cache()
    return results


def bench_plan(device):
    """The benchmark graph's plan (``perfbench/rmat.py`` at structure seed
    0, 65,536 nodes, 16 switching-aware partitions, ``build_plan`` with GCN
    weights and its power-of-two padding), topologies on ``device``. Its
    unit 0's layer-0 aggregate, ``segment_sum``'s main-path shape, sums
    524,288 edge rows into 8,192 destinations, row 0 with the padded
    tail."""
    from perfbench.rmat import rmat_graph
    from repro_torch.core.plan import build_plan
    from repro_torch.graph.csr import CSRGraph, gcn_norm_coeffs
    from repro_torch.graph.partition import switching_aware_partition

    indptr, indices = rmat_graph(C_NODES, AVG_DEGREE, 0, 0.57, 0.19, 0.19)
    g = CSRGraph(indptr=indptr, indices=indices, n_nodes=C_NODES)
    parts = switching_aware_partition(g, N_PARTS, seed=0).parts
    return build_plan(g, parts, N_PARTS, edge_weight=gcn_norm_coeffs(g),
                      device=device)


def phase_a_segment_sum(dev, d: int = DIMS[0]) -> dict:
    """``segment_sum`` at the main path's largest shape: unit 0's layer-0
    aggregate in ``bench_plan`` (524,288 x 1,024 rows of ``torch.Generator``
    seed 0 over its ``dst`` ids): bitwise its plain version on the card
    (``ref.segment_sum_ref``) and itself on a rerun, and on every segment
    of at most ``SEGMENT_CHUNK`` edges bitwise ``index_put_(accumulate=
    True)``; kernel, plain and ``index_put_`` (the library) times by
    ``time_ms``; the bound: each edge row read once, the ids and positions
    (12 bytes an edge) and each output row written once, at HBM's rate."""
    import torch

    from repro_torch.kernels.gather_scatter import ops, ref

    t = bench_plan(dev).units[0].topo
    dst, n = t.dst, t.n_dst
    E, K = dst.shape[0], ops.SEGMENT_CHUNK
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((E, d), generator=gen, device=dev)
    deg = torch.bincount(dst.long(), minlength=n)
    k = ops.segment_sum(x, dst, n)
    p = ref.segment_sum_ref(x, dst, n, K)
    lib = x.new_zeros((n, d)).index_put_((dst.long(),), x, accumulate=True)
    short = deg <= K
    check(torch.equal(k, p),
          f"segment_sum bitwise vs plain at {E} x {d} into {n} rows (row 0 "
          f"{int(deg[0])} edges, {int((~short).sum())} rows of more than "
          f"{K})")
    check(torch.equal(ops.segment_sum(x, dst, n), k),
          "segment_sum deterministic (rerun bitwise)")
    check(torch.equal(k[short], lib[short]),
          f"segment_sum bitwise index_put_(accumulate=True) on the "
          f"{int(short.sum())} rows of at most {K} edges")
    b_ms, b_by = bound(E * d * 4 + 12 * E + n * d * 4, 0.0)
    r = dict(
        max_abs_err=float((k - p).abs().max()),
        ms=time_ms(lambda: ops.segment_sum(x, dst, n)),
        plain_ms=time_ms(lambda: ref.segment_sum_ref(x, dst, n, K)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: x.new_zeros((n, d)).index_put_(
            (dst.long(),), x, accumulate=True)),
    )
    del x, k, p, lib
    torch.cuda.empty_cache()
    return r


def print_row(name: str, r: dict) -> None:
    lib = (f"{r['library_ms']:.4f} ms" if r["library_ms"] is not None
           else "none")
    print(f"  {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
          f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
          f"{lib}, max abs err {r['max_abs_err']:.3e}", flush=True)


def link_gbps(dev) -> dict:
    """The host link's rate each way, GB/s: four 256 MB copies between
    pinned host memory and the card, CUDA events."""
    import torch

    n = 256 << 20
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(n, dtype=torch.uint8, device=dev)
    out = {}
    for name, dst, src in (("h2d", card, host), ("d2h", host, card)):
        dst.copy_(src, non_blocking=True)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(4):
            dst.copy_(src, non_blocking=True)
        b.record()
        b.synchronize()
        out[name] = 4 * n / (a.elapsed_time(b) * 1e-3) / 1e9
    return out


def phase_a_scatter(plan, d: int, dev) -> dict:
    """``scatter_add`` bitwise vs the numpy oracle at small shapes, then at
    phase D's largest non-contiguous grad write-back (the partition's grad
    buffer, width ``d``) bitwise vs its plain version, on a device base and,
    as the engine runs it, in place in a page-locked host base
    (``scatter_add_host_``, one launch); times. The row is the host-mapped
    launch's, against its link bound (each touched base row over the link
    once each way, at the slower way's measured rate)."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.gather_scatter import ops, ref
    from repro_torch.runtime.pinned import page_locked_empty

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
    host = page_locked_empty(tuple(base.shape), np.float32)
    host[...] = base.cpu().numpy()
    ht = torch.from_numpy(host)
    reset_launches()              # this launch's count starts here
    ops.scatter_add_host_(ht, rows, values)
    torch.cuda.synchronize()
    check(launch_counts()["scatter_add"] == 1
          and torch.equal(ht, p.cpu()),
          f"scatter_add_host_ (in place in a page-locked base) bitwise vs "
          f"plain at the same inputs, one launch")
    U = int(torch.unique(rows).numel())
    b_ms, b_by = bound(R * d * 4 + 2 * U * d * 4 + 4 * R, float(R * d))
    link = link_gbps(dev)
    l_ms = U * d * 4 / (min(link["h2d"], link["d2h"]) * 1e9) * 1e3
    kb, pb, lb = base.clone(), base.clone(), base.clone()
    hb = torch.from_numpy(page_locked_empty(tuple(base.shape), np.float32))
    hb.copy_(ht)
    q = queued_ms({
        "scatter_add_host": lambda: ops.scatter_add_host_(hb, rows, values),
        "scatter_add": lambda: ops.scatter_add_(kb, rows, values),
        "index_add_": lambda: lb.index_add_(0, rows, values)})
    out = dict(
        max_abs_err=float((ht - p.cpu()).abs().max()),
        ms=q["scatter_add_host"],
        plain_ms=time_ms(lambda: ref.scatter_add_ref(pb, rows, values)),
        bound_ms=l_ms, bound_by="link bytes", library_ms=q["index_add_"],
    )
    print(f"  scatter_add queued (median of 200 launches each, a b c c b "
          f"a): in place in page-locked host memory {q['scatter_add_host']:.4f}"
          f" ms (link bound {l_ms:.4f} ms: {U} rows x {d} each way, link "
          f"{link['h2d']:.1f} / {link['d2h']:.1f} GB/s H2D / D2H); on a "
          f"device base {q['scatter_add']:.4f} ms (HBM bound {b_ms:.4f} ms, "
          f"{b_by}); index_add_ {q['index_add_']:.4f} ms; time_ms's 5-call "
          f"means: device base "
          f"{time_ms(lambda: ops.scatter_add_(kb, rows, values)):.4f}, "
          f"index_add_ {time_ms(lambda: lb.index_add_(0, rows, values)):.4f}",
          flush=True)
    del k, p, kb, pb, lb, hb, ht, host, base, values
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


def flash_inputs(B: int, S: int, Hq: int, Hkv: int, D: int, dev):
    """bf16 q ``(B, S, Hq, D)`` and k, v ``(B, S, Hkv, D)`` on the card,
    standard normal from a ``torch.Generator`` of seed 0."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, S, Hq, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, S, Hkv, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, S, Hkv, D), generator=gen, device=dev).bfloat16()
    return q, k, v


def flash_vs_plain(q, k, v, window=None):
    """One causal ``flash_attention`` launch on bf16 ``q``, ``k``, ``v``
    (with a sliding ``window`` if given) held against
    ``flash_attention_ref`` on the same inputs: every element within 2^-7
    |plain| + 1e-6, at least 99% of them bitwise equal, and a rerun
    bitwise. Returns ``(kernel's output, plain's, max abs err)``."""
    import torch

    from repro_torch.kernels.flash_attention import ops, ref

    t0 = time.perf_counter()
    kern = ops.flash_attention(q, k, v, True, window)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    plain = ref.flash_attention_ref(q, k, v, True, window)
    torch.cuda.synchronize()
    kf, pf = kern.float(), plain.float()
    err = (kf - pf).abs()
    check(bool(torch.all(err <= 2.0 ** -7 * pf.abs() + 1e-6)),
          f"flash_attention bf16 within 2^-7 |plain| + 1e-6 of plain at "
          f"q {tuple(q.shape)}, k/v {tuple(k.shape)}, causal, window "
          f"{window} (max abs err {float(err.max()):.3e}; first launch "
          f"{t_first:.3f} s)")
    same = float((kern == plain).float().mean())
    check(same >= 0.99, f"flash_attention: {same:.6f} of the elements "
          f"bitwise equal to plain (>= 0.99)")
    check(torch.equal(ops.flash_attention(q, k, v, True, window), kern),
          "flash_attention deterministic (rerun bitwise)")
    return kern, plain, float(err.max())


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
    q, k, v = flash_inputs(B, S, Hq, Hkv, D, dev)
    kern, plain, max_err = flash_vs_plain(q, k, v)
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
    # one launch per unit and layer in each of the two runs (depth 0, 2):
    # the stack's regather and the aggregate, or the fused kernel
    per_path = 2 * (len(DIMS) - 1) * sum(
        1 for p in plan.schedule if plan.unit(p).n_edges > 0)
    expect = {
        "reference": dict(NO_LAUNCHES, segment_sum=per_path),
        "kernel": dict(NO_LAUNCHES, gather_rows=per_path,
                       segment_sum=per_path),
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
    # the segment sums of a run's layer and unit with edges: the forward's
    # aggregate, the backward's recompute of it, the edge gather's
    # transpose; kernel-fused's forward is gather_aggregate
    sums = 2 * L * fused_units
    expect = {
        "reference": dict(NO_LAUNCHES, segment_sum=3 * sums),
        "kernel": dict(NO_LAUNCHES, gather_rows=2 * 2 * L * units,
                       scatter_add=scatters, segment_sum=3 * sums),
        "kernel-fused": dict(NO_LAUNCHES, gather_rows=2 * L * units,
                             gather_aggregate=2 * L * fused_units,
                             scatter_add=scatters, segment_sum=2 * sums),
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
        if mode != "reference":
            pairs = [(run["counters"].scatter_inplace_pairs,
                      run["counters"].scatter_copy_pairs)
                     for run in r["runs"].values()]
            check(all(p == (scatters // 2, 0) for p in pairs),
                  f"{mode}: every scatter_add launch in place in a "
                  f"page-locked grad buffer (in place / round trip pairs "
                  f"{pairs} a run)")
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
    # recompute) per layer and unit; the softmax only where a unit has edges.
    # Segment sums per run, layer and unit with edges: ten in reference
    # (the softmax's denominator and the aggregate in the forward and the
    # recompute, and the transposes of the layer's six edge gathers); seven
    # in kernel-fused, where edge_softmax takes the denominator and the two
    # gathers of its max and sum, and the softmax's vjp sums once
    sums = 2 * L * edge_units
    expect = {
        "reference": dict(NO_LAUNCHES, segment_sum=10 * sums),
        "kernel-fused": dict(NO_LAUNCHES, gather_rows=2 * 2 * L * units,
                             scatter_add=scatters,
                             edge_softmax=2 * 2 * L * edge_units,
                             segment_sum=7 * sums),
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
    edge_units = sum(1 for p in plan.schedule if plan.unit(p).n_edges > 0)
    # two runs (depth 0, 2) x two passes (forward, backward regather) per
    # layer and unit, and phase D's grad write-backs
    expect = dict(NO_LAUNCHES, gather_rows=2 * 2 * L * units,
                  scatter_add=2 * (L - 1) * len(scatter_row_sets(plan)))
    # segment sums per run, layer and unit with edges: each family's
    # aggregates in the forward and the recompute, and the transposes of
    # its edge gathers
    sums = {"sage": 4, "gin": 4, "pna": 6, "graphcast": 5}
    launches = {}
    for model in sums:
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
        want = dict(expect, segment_sum=sums[model] * 2 * L * edge_units)
        check(launches[model] == want,
              f"{model}: launches {launches[model]} == {want}")
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


def phase_j_tiers(smi: str, dev) -> dict:
    """The cost model's four tiers measured; returns them (B/s)."""
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
    return t


def phase_j_modeled(fused: dict, n: int, e: int) -> None:
    """``modeled_time`` (``H100_MACHINE``) of phase D's kernel-fused depth-2
    run: its ``Counters`` (the epoch and the ``initialize`` before it, which
    writes the layer-0 table), ``gnn_epoch_flops(n, e, DIMS)`` and its
    measured wall (one epoch + AdamW)."""
    from repro_torch.core.costmodel import (
        H100_MACHINE, gnn_epoch_flops, modeled_time,
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


def phase_j(g, fused: dict, smi: str, dev):
    """Phase J; returns its launches, summed over its runs, and the
    measured tiers."""
    phase_j_microbatch(g, dev)
    tiers = phase_j_tiers(smi, dev)
    phase_j_modeled(fused, g.n_nodes, g.n_edges)
    launches = dict(NO_LAUNCHES)
    for run in (phase_j_telemetry, phase_j_ledger, phase_j_example):
        for k, v in run(dev).items():
            launches[k] += v
    return launches, tiers


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


def roundtrip(model, tol: float, tally) -> float:
    """A prompt of ``ROUNDTRIP_SEQ`` tokens (numpy seed 1) decoded token by
    token against ``lm_forward`` on the same tokens in kernel mode
    (``n_layers`` ``flash_attention`` launches for GQA, none for MLA): the
    logits within ``tol`` max-relative at every position. With MoE layers
    the forward's and each step's expert choices are recorded
    (:class:`routing`). In bf16 the two routes' rounding can send a token
    whose router logits nearly tie to another expert set; that token's
    logits, and every later one's through attention, then differ by more
    than rounding. Each such flip is printed with its layer and position
    and the forward's and the decode's top-k margins there, and the prompt
    is decoded again with every step fed the forward's experts
    (``moe_ffn``'s ``experts``; the gates still the decode's own), and
    that decode is held. In float32 no flip is allowed. Returns the
    error."""
    import numpy as np
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.models.lm.steps import make_decode_step
    from repro_torch.models.lm.transformer import init_kv_cache, lm_forward

    cfg, dev = model.cfg, model.device
    T = ROUNDTRIP_SEQ
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, T)).astype(np.int32)).to(dev)
    reset_launches()
    with routing() as fwd, torch.no_grad():
        full, _ = lm_forward(model, toks, "kernel")
    step = make_decode_step(cfg, "kernel", dev)

    def decode(force=None):
        cache = init_kv_cache(cfg, 1, T, device=dev)
        with routing(force) as steps:
            dec = torch.stack([step(model, cache, toks[:, t:t + 1], t + 1)[0]
                               for t in range(T)], dim=1)
        return dec, steps

    dec, steps = decode()
    fed = ""
    if fwd.choices:
        # the decode calls the MoE FFNs once a token and MoE layer, in order
        n = len(fwd.choices)
        flips = torch.stack([
            (a.sort(-1)[0] != torch.cat(steps.choices[j::n]).sort(-1)[0])
            .any(-1) for j, a in enumerate(fwd.choices)]).nonzero().tolist()
        if flips:
            dm = [torch.cat(steps.margins[j::n]) for j in range(n)]
            note = (f"{len(flips)} of {n * T} routing decisions differ from "
                    f"the forward's, the first at position "
                    f"{min(t for _, t in flips)} (MoE layer, position: the "
                    f"forward's / the decode's top-k margin: " + ", ".join(
                        f"{j}, {t}: {float(fwd.margins[j][t]):.3e} / "
                        f"{float(dm[j][t]):.3e}" for j, t in flips)
                    + f"; the forward's smallest margin anywhere "
                    f"{min(float(m.min()) for m in fwd.margins):.3e})")
            if cfg.dtype == torch.float32:
                check(False, f"float32: decode and forward route every "
                      f"token alike ({note})")
            print(f"  {cfg.name} {cfg.dtype}: {note}; the decode's error "
                  f"over all {T} positions "
                  f"{rel_err(full.cpu().numpy(), dec.cpu().numpy()):.3e}",
                  flush=True)
            dec, _ = decode(fwd.choices)
            fed = ", every step fed the forward's experts"
    torch.cuda.synchronize()
    tally(cfg.n_layers if cfg.attn_type == "gqa" else 0,
          f"{cfg.dtype} decode == prefill at {T} tokens")
    full, dec = full.cpu().numpy(), dec.cpu().numpy()
    err = rel_err(full, dec)
    check(bool(np.isfinite(dec).all()) and err <= tol,
          f"{cfg.name} {cfg.dtype}, {cfg.n_layers} layers: {T} tokens "
          f"decoded one at a time{fed} == lm_forward (kernel) within {tol} "
          f"max-relative at every position ({err:.3e}; the reference's "
          f"float32 figure is 2e-5)")
    return err


# ----------------------------------------------------------------- phase L
def t_rel_err(a, b) -> float:
    """``max |a - b| / max |a|`` on the tensors' device (float32: the
    difference of two bf16 or float32 values is exact there)."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))


def phase_l_train(smi: str, dev) -> None:
    """Phi-3-medium-14B ``train_4k`` at its published widths, cut to
    ``L_LAYERS`` layers and batch ``L_BATCH`` of ``L_SEQ`` tokens: the
    launcher's ``_lm_train`` (``make_train_step``, AdamW in place),
    ``L_STEPS`` steps on one batch (numpy seed 0, weights from
    ``torch.Generator`` seed 0)."""
    import dataclasses

    import torch

    from repro_torch.configs.phi3_medium_14b import CONFIG
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.train import _lm_train, lm_cell_bytes
    from repro_torch.models.lm.transformer import init_lm_params

    cfg = dataclasses.replace(CONFIG, n_layers=L_LAYERS)
    need = lm_cell_bytes(cfg, "train", L_BATCH, L_SEQ)
    print(f"phase L: {cfg.name} train_4k at its published widths (d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.d_head}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, "
          f"seq {L_SEQ}); cut: {CONFIG.n_layers} -> {L_LAYERS} layers, batch "
          f"256 -> {L_BATCH}; reckoned {need['total'] / 1e9:.2f} GB; {smi}",
          flush=True)
    model = init_lm_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    reset_launches()
    r = _lm_train(model, L_BATCH, L_SEQ, L_STEPS)
    n = launch_counts()
    check(not any(n.values()) and r["launches"] == 0,
          f"train steps launch no kernel ({n}): training attends through "
          f"chunked_attention")
    check(r["finite"], f"{L_STEPS} steps: every loss, m and v finite")
    check(r["losses"][-1] < r["losses"][0],
          f"the loss falls: {r['losses'][0]:.6f} -> {r['losses'][-1]:.6f} "
          f"(step 1 beside ln {cfg.vocab} = {math.log(cfg.vocab):.3f})")
    for i, (w, tps, tf) in enumerate(zip(r["walls_s"], r["tokens_per_s"],
                                         r["tflops"])):
        print(f"  step {i + 1}: loss {r['losses'][i]:.6f}, wall {w:.4f} s, "
              f"{tps:.1f} tokens/s, {tf:.2f} TFLOP/s", flush=True)
    print(f"  peak device {r['peak_gb']:.2f} GB (reckoned "
          f"{need['total'] / 1e9:.2f}: " + ", ".join(
              f"{k} {v / 1e9:.2f}" for k, v in need.items() if k != "total")
          + ")", flush=True)
    del model
    torch.cuda.empty_cache()


def phase_l_remat(dev) -> None:
    """Remat on and off at Phi-3's widths, ``L_REMAT_LAYERS`` layers,
    batch 1 of ``L_SEQ`` tokens, the same weights: the loss and every
    gradient bitwise; then
    the checkpointed ``chunked_attention``'s q, k, v gradients against a
    plain autograd pass in float32 at one Phi-3 layer's attention."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.phi3_medium_14b import CONFIG
    from repro_torch.models.lm.attention import chunked_attention
    from repro_torch.models.lm.transformer import (
        init_lm_params, lm_value_and_grad,
    )

    cfg = dataclasses.replace(CONFIG, n_layers=L_REMAT_LAYERS)
    model = init_lm_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, L_SEQ)).astype(np.int32)).to(dev)
    out = {}
    for remat in (True, False):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out[remat] = lm_value_and_grad(model, toks)
        torch.cuda.synchronize()
        print(f"  remat {remat}: {time.perf_counter() - t0:.3f} s, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB",
              flush=True)
    model.cfg = cfg
    (a, ga), (b, gb) = out[True], out[False]
    check(torch.equal(a[0], b[0]),
          f"{L_REMAT_LAYERS} layers, batch 1 x {L_SEQ}: remat on == off "
          f"loss bitwise ({float(a[0]):.6f})")
    differ = sorted(k for k in ga if not torch.equal(ga[k], gb[k]))
    check(not differ, f"remat on == off: all {len(ga)} gradients bitwise "
          f"(differ: {differ})")
    del model, out, ga, gb
    torch.cuda.empty_cache()

    gen = torch.Generator(dev).manual_seed(1)
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q, k, v = randn(1, L_SEQ, H, D), randn(1, L_SEQ, Hkv, D), \
        randn(1, L_SEQ, Hkv, D)
    w = randn(1, L_SEQ, H, D)
    grads = {}
    for ck in (True, False):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = chunked_attention(*qkv, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk, kv_checkpoint=ck)
        grads[ck] = torch.autograd.grad((o * w).sum(), qkv)
    errs = [t_rel_err(p, c) for p, c in zip(grads[False], grads[True])]
    check(max(errs) <= L_ATTN_TOL,
          f"checkpointed chunked_attention (q {tuple(q.shape)}, float32): "
          f"q, k, v gradients within {L_ATTN_TOL} max-relative of plain "
          f"autograd's ({', '.join(f'{e:.3e}' for e in errs)})")
    del grads, q, k, v, w
    torch.cuda.empty_cache()


class routing:
    """Inside, every MoE FFN the port calls records its tokens' top-k
    experts in ``topk``'s order (``choices``, ``(T, K)`` a call) and each
    token's gap between its k-th and (k+1)-th router logit (``margins``,
    ``(T,)`` a call): where two routes' rounding could pick another
    expert. With ``force``, a forward's ``choices`` (one a MoE layer), the
    calls of a one-token-a-step decode are routed to the forward's experts
    instead of their own top k: the ``n``-th call is token ``n // L`` of
    MoE layer ``n % L``. Outside, nothing is recorded."""

    def __init__(self, force=None):
        self.force = force

    def __enter__(self):
        import torch

        from repro_torch.models.lm import transformer
        from repro_torch.models.lm.moe import moe_shape

        self.choices, self.margins = [], []
        self._ffn = ffn = transformer.moe_ffn

        def recording(p, x, mcfg):
            # the router's product as moe_ffn groups it, so a near-tie
            # resolves as it does there
            T, d = x.shape
            G = moe_shape(mcfg, T)[0]
            lg = (x.float().reshape(G, T // G, d) @ p.router).reshape(T, -1)
            top = torch.topk(lg, mcfg.top_k + 1, dim=-1)
            self.choices.append(top[1][:, :-1])
            self.margins.append(top[0][:, -2] - top[0][:, -1])
            if self.force is None:
                return ffn(p, x, mcfg)
            n, L = len(self.choices) - 1, len(self.force)
            return ffn(p, x, mcfg,
                       experts=self.force[n % L][n // L:n // L + T])

        transformer.moe_ffn = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models.lm import transformer

        transformer.moe_ffn = self._ffn


def router_margin(model, toks) -> float:
    """The smallest top-k margin (:class:`routing`) over every MoE layer
    and token of a reference forward of ``toks``."""
    import torch

    from repro_torch.models.lm.transformer import lm_forward

    with routing() as r, torch.no_grad():
        lm_forward(model, toks, "reference")
    return min(float(m.min()) for m in r.margins)


def phase_l_card_vs_cpu(dev, names) -> None:
    """Each of the LM ids ``names``' ``SMOKE``: ``lm_loss`` and its
    gradients, then one in-place AdamW step, on the card and on the CPU
    from the same weights and tokens, within ``L_CPU_TOL`` max-relative.
    For an MoE id the router's smallest top-k margin on those tokens is
    printed beside it (:func:`router_margin`)."""
    import numpy as np
    import torch

    from repro_torch.configs import REGISTRY
    from repro_torch.models.lm.steps import make_train_step
    from repro_torch.models.lm.transformer import (
        init_lm_params, lm_value_and_grad,
    )
    from repro_torch.optim import adamw_init

    cpu = torch.device("cpu")
    for name in names:
        cfg = REGISTRY[name].smoke_config
        toks = np.random.default_rng(0).integers(
            0, cfg.vocab, (2, 64)).astype(np.int32)
        res = []                         # the card's, then the CPU's
        for d in (dev, cpu):
            model = init_lm_params(cfg, torch.Generator(cpu).manual_seed(0),
                                   cpu).to(d)
            t = torch.from_numpy(toks).to(d)
            (loss, _), grads = lm_value_and_grad(model, t)
            opt = adamw_init(model)
            step = make_train_step(cfg, device=d)[0]
            step(model, opt, t)
            res.append(dict(
                loss=loss.reshape(1), **{f"g.{k}": v for k, v in grads.items()},
                **{f"p.{k}": v for k, v in model.named_parameters()},
                **{f"m.{k}": v for k, v in opt["m"].items()},
                **{f"v.{k}": v for k, v in opt["v"].items()}))
        card, host = res
        errs = {k: t_rel_err(host[k], card[k].cpu()) for k in host}
        worst = max(errs, key=errs.get)
        n_grads = sum(k.startswith("g.") for k in host)
        margin = ""
        if cfg.moe is not None:
            model = init_lm_params(cfg, torch.Generator(cpu).manual_seed(0),
                                   cpu)
            margin = (f"; router's smallest top-k margin "
                      f"{router_margin(model, torch.from_numpy(toks)):.3e}")
        check(errs[worst] <= L_CPU_TOL,
              f"{name} SMOKE: card vs CPU loss, {n_grads} gradients, "
              f"parameters, m and v after one step within {L_CPU_TOL} "
              f"max-relative (worst {worst} {errs[worst]:.3e}, loss "
              f"{errs['loss']:.3e}{margin})")


def phase_l_flash(dev) -> dict:
    """``command-r-plus-104b`` (96 / 8 heads: groups of 12) and
    ``deepseek-67b`` (64 / 8: groups of 8) at ``CONFIG`` widths,
    ``L_FLASH_LAYERS`` layers: a ``CHECK_SEQ``-token prefill at batch 1
    in kernel and reference modes, last logits within ``LM_KERNEL_TOL``,
    exactly ``L_FLASH_LAYERS`` ``flash_attention`` launches in kernel
    mode. Then the wrapper itself at each id's prefill shape (q ``(1,
    CHECK_SEQ, Hq, d_head)``, k / v ``(1, CHECK_SEQ, Hkv, d_head)``, bf16)
    against the plain version, as phase A holds it (:func:`flash_vs_plain`;
    those launches compare, and are not counted). Returns each kernel's
    launches in the prefills."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.lm.steps import make_prefill_step
    from repro_torch.models.lm.transformer import init_lm_params

    counts = dict(NO_LAUNCHES)
    for name in ("command-r-plus-104b", "deepseek-67b"):
        cfg = dataclasses.replace(REGISTRY[name].config,
                                  n_layers=L_FLASH_LAYERS)
        model = init_lm_params(cfg, torch.Generator(dev).manual_seed(0), dev)
        toks = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (1, CHECK_SEQ)).astype(np.int32)).to(dev)
        logits = {}
        for mode in ("kernel", "reference"):
            reset_launches()
            logits[mode] = make_prefill_step(cfg, mode, dev)(model, toks)
            torch.cuda.synchronize()
            n = launch_counts()
            want = L_FLASH_LAYERS if mode == "kernel" else 0
            check(n == dict(NO_LAUNCHES, flash_attention=want),
                  f"{name} prefill {mode}: launches {n} == {want} "
                  f"flash_attention")
            for k, v in n.items():
                counts[k] += v
        err = rel_err(logits["reference"].cpu().numpy(),
                      logits["kernel"].cpu().numpy())
        check(bool(torch.isfinite(logits["kernel"]).all())
              and err <= LM_KERNEL_TOL,
              f"{name} ({cfg.n_heads}/{cfg.n_kv_heads} heads, groups of "
              f"{cfg.n_heads // cfg.n_kv_heads}), {L_FLASH_LAYERS} layers, "
              f"{CHECK_SEQ} tokens: kernel's last logits within "
              f"{LM_KERNEL_TOL} max-relative of reference's ({err:.3e})")
        del model, logits, toks
        torch.cuda.empty_cache()
        q, k, v = flash_inputs(1, CHECK_SEQ, cfg.n_heads, cfg.n_kv_heads,
                               cfg.d_head, dev)
        err = flash_vs_plain(q, k, v)[2]
        print(f"  {name}: flash_attention at q {tuple(q.shape)}, k/v "
              f"{tuple(k.shape)} against plain: max abs err {err:.3e}",
              flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return counts


def phase_l(smi: str, dev) -> dict:
    """Phase L: dense-LM training on the card. The three dense LM ids'
    ``smoke()`` run in phase K's registry pass with every other id.
    Returns each kernel's launches over its runs."""
    dense = ("phi3-medium-14b", "command-r-plus-104b", "deepseek-67b")
    for part in (lambda: phase_l_train(smi, dev), lambda: phase_l_remat(dev),
                 lambda: phase_l_card_vs_cpu(dev, dense)):
        t0 = time.perf_counter()
        part()
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    counts = phase_l_flash(dev)
    print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    return counts


# ----------------------------------------------------------------- phase M
def launch_tally(counts: dict):
    """``tally(want_flash, what)``: the kernel launches since the last
    ``reset_launches`` are exactly ``want_flash`` ``flash_attention`` ones,
    added into ``counts``."""
    from repro_torch.kernels import launch_counts

    def tally(want_flash: int, what: str) -> None:
        n = launch_counts()
        check(n == dict(NO_LAUNCHES, flash_attention=want_flash),
              f"{what}: launches {n} == {want_flash} flash_attention")
        for k, v in n.items():
            counts[k] += v

    return tally


def gb(model) -> float:
    """The model's parameter bytes, in GB."""
    return sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9


def reckoned(need: dict) -> str:
    return f"{need['total'] / 1e9:.2f} GB (" + ", ".join(
        f"{k} {v / 1e9:.2f}" for k, v in need.items() if k != "total") + ")"


def no_drops(cfg, n_tokens: int, what: str) -> None:
    """A token sends at most one assignment to an expert, so a group's
    queue for an expert never holds more than the group's tokens: with
    ``T / G <= C`` no assignment is dropped (and a forward and a decode of
    the same tokens route them alike)."""
    from repro_torch.models.lm.moe import moe_shape

    G, C = moe_shape(cfg.moe, n_tokens)
    check(n_tokens // G <= C, f"{what}: {n_tokens} tokens in {G} groups "
          f"of {n_tokens // G} <= capacity {C}: no assignment dropped")


def lm_serving(model, tally, smi: str, rt_tol: float) -> None:
    """The serving checks of phase M on ``model`` (bf16, ``CONFIG``
    widths cut in depth): for GQA the kernel route against the plain one
    at ``CHECK_SEQ`` tokens within ``M_KERNEL_TOL`` (MLA has no kernel
    route), ``prefill_32k`` at batch 1 and ``decode_32k`` at batch 4
    through the launcher's ``_lm_prefill`` / ``_lm_decode`` (reckoned by
    ``lm_cell_bytes`` and printed beside the peak, the decode beside two
    bounds at 3.35 TB/s: every weight and the cache read once, and only
    the experts each step's tokens route to, counted on a second run of
    the same steps under :class:`routing`), and decode == prefill at
    ``ROUNDTRIP_SEQ`` tokens within ``rt_tol`` (:func:`roundtrip`)."""
    import numpy as np
    import torch

    from repro_torch.kernels import reset_launches
    from repro_torch.launch.train import _lm_decode, _lm_prefill, lm_cell_bytes
    from repro_torch.models.lm.steps import make_prefill_step

    cfg, dev = model.cfg, model.device
    L = cfg.n_layers
    flash = L if cfg.attn_type == "gqa" else 0
    if flash:
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
            tally(flash if mode == "kernel" else 0,
                  f"prefill {mode} at {CHECK_SEQ} tokens")
        err = rel_err(logits["reference"].cpu().numpy(),
                      logits["kernel"].cpu().numpy())
        check(bool(torch.isfinite(logits["kernel"]).all())
              and err <= M_KERNEL_TOL,
              f"{cfg.name} prefill at {CHECK_SEQ} tokens, {L} layers: "
              f"kernel's last logits within {M_KERNEL_TOL} max-relative of "
              f"reference's ({err:.3e})")
        del logits, toks

    need = lm_cell_bytes(cfg, "prefill", PREFILL_BATCH, PREFILL_SEQ)
    reset_launches()
    r = _lm_prefill(model, PREFILL_BATCH, PREFILL_SEQ, "kernel",
                    warmup_seq=PREFILL_WARMUP_SEQ)
    tally(2 * flash, f"prefill_32k (warm-up at {PREFILL_WARMUP_SEQ} + "
          f"timed)")
    check(r["launches"] == flash and r["finite"],
          f"prefill_32k: {r['launches']} flash_attention launches in the "
          f"timed call == {flash}, finite last logits "
          f"{tuple(r['logits'].shape)}")
    print(f"  prefill_32k (batch {PREFILL_BATCH}, {PREFILL_SEQ} tokens): "
          f"wall {r['wall_s']:.4f} s, {r['tokens_per_s']:.1f} tokens/s, "
          f"{r['tflops']:.2f} TFLOP/s, peak device {r['peak_gb']:.2f} GB "
          f"(reckoned {reckoned(need)}); {smi}", flush=True)
    del r
    torch.cuda.empty_cache()

    need = lm_cell_bytes(cfg, "decode", DECODE_BATCH, DECODE_SEQ)
    reset_launches()
    d = _lm_decode(model, DECODE_BATCH, DECODE_SEQ, DECODE_STEPS)
    tally(0, "decode_32k")
    check(d["finite"], f"decode_32k: {DECODE_STEPS} steps' logits finite")
    weights = gb(model) * 1e9
    bound_ms = (weights + need["cache"]) / HBM_BYTES_PER_S * 1e3
    print(f"  decode_32k (batch {DECODE_BATCH}, cache {DECODE_SEQ} "
          f"positions, {need['cache'] / 1e9:.2f} GB, filled to "
          f"{DECODE_FILL}): p50 {d['p50_ms']:.3f} ms, p99 {d['p99_ms']:.3f} "
          f"ms a step, {d['tokens_per_s']:.1f} tokens/s, peak device "
          f"{d['peak_gb']:.2f} GB (reckoned {reckoned(need)}); bound "
          f"(every weight, {weights / 1e9:.2f} GB, and the cache at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s) {bound_ms:.3f} ms", flush=True)
    del d
    torch.cuda.empty_cache()
    if cfg.moe is not None:
        # the same steps again (same seeds, so the same tokens and routes),
        # untimed, counting the experts each step's tokens route to
        with routing() as r:
            _lm_decode(model, DECODE_BATCH, DECODE_SEQ, DECODE_STEPS)
        m = cfg.moe
        n = L - m.first_dense
        per = 3 * cfg.d_model * m.d_ff_expert * model.layers[0].w_gate \
            .element_size()
        used = [sum(int(c.unique().numel()) for c in r.choices[i:i + n])
                for i in range(0, len(r.choices), n)]
        base = weights - n * m.n_experts * per + need["cache"]
        act = [(base + u * per) / HBM_BYTES_PER_S * 1e3 for u in used]
        print(f"  decode_32k's active-expert bound (the dense weights, the "
              f"cache, and the {min(used)}..{max(used)} of {n} x "
              f"{m.n_experts} experts a step's {DECODE_BATCH} tokens route "
              f"to): {min(act):.3f}..{max(act):.3f} ms a step, median "
              f"{float(np.median(act)):.3f} ms", flush=True)
        del r
        torch.cuda.empty_cache()

    no_drops(cfg, ROUNDTRIP_SEQ, "decode == prefill's forward")
    no_drops(cfg, 1, "decode == prefill's steps")
    roundtrip(model, rt_tol, tally)


def phase_m_mixtral(smi: str, dev, counts: dict) -> None:
    """Mixtral-8x7B serving at ``CONFIG`` widths, ``M_LAYERS`` layers
    (:func:`lm_serving`), weights from ``torch.Generator`` seed 0."""
    import dataclasses

    import torch

    from repro_torch.configs.mixtral_8x7b import CONFIG
    from repro_torch.models.lm.transformer import count_params, init_lm_params

    cfg = dataclasses.replace(CONFIG, n_layers=M_LAYERS)
    print(f"phase M: {cfg.name} serving at its published widths (d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.d_head}, window {cfg.window}, {cfg.moe.n_experts} experts "
          f"of {cfg.moe.d_ff_expert} top-{cfg.moe.top_k}, vocab "
          f"{cfg.vocab}, {cfg.dtype}); cut: {CONFIG.n_layers} -> {M_LAYERS} "
          f"layers", flush=True)
    t0 = time.perf_counter()
    model = init_lm_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    check(n == count_params(cfg) == cfg.param_count() + cfg.d_model,
          f"{n:,} parameters == param_count() {cfg.param_count():,} + the "
          f"final norm ({gb(model):.2f} GB; made in "
          f"{time.perf_counter() - t0:.1f} s)")
    lm_serving(model, launch_tally(counts), smi, M_ROUNDTRIP_TOL)
    del model
    torch.cuda.empty_cache()


def phase_m_small(smi: str, dev, counts: dict) -> None:
    """Mixtral at ``M_SMALL_LAYERS`` layers, ``CONFIG`` widths: (1)
    ``long_500k`` at batch 1, ``M_LONG_STEPS`` steps against a
    ``M_LONG_SEQ``-position cache, finite; (2) ``train_4k`` at batch
    ``M_TRAIN_BATCH``, ``L_STEPS`` steps of the launcher's ``_lm_train``:
    every loss, ``m`` and ``v`` finite, the loss falling, the aux printed
    each step, no kernel launched; (3) the kernel route against the plain
    one and decode == prefill in float32 within ``LM_F32_TOL``; (4) remat
    on vs off at one layer, batch 1: the loss, the aux and every gradient
    bitwise."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs.mixtral_8x7b import CONFIG
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.train import _lm_decode, _lm_train, lm_cell_bytes
    from repro_torch.models.lm.steps import make_prefill_step
    from repro_torch.models.lm.transformer import (
        init_lm_params, lm_value_and_grad,
    )

    tally = launch_tally(counts)
    cfg = dataclasses.replace(CONFIG, n_layers=M_SMALL_LAYERS)
    model = init_lm_params(cfg, torch.Generator(dev).manual_seed(0), dev)

    # 1. long_500k, the cell's first run anywhere
    need = lm_cell_bytes(cfg, "decode", 1, M_LONG_SEQ)
    reset_launches()
    d = _lm_decode(model, 1, M_LONG_SEQ, M_LONG_STEPS)
    tally(0, "long_500k")
    check(d["finite"], f"long_500k ({M_SMALL_LAYERS} layers, batch 1, "
          f"{M_LONG_SEQ} positions, {need['cache'] / 1e9:.2f} GB of cache, "
          f"window {cfg.window}): {M_LONG_STEPS} steps' logits finite")
    print(f"  long_500k: p50 {d['p50_ms']:.3f} ms, p99 {d['p99_ms']:.3f} ms "
          f"a step, peak device {d['peak_gb']:.2f} GB (reckoned "
          f"{reckoned(need)}); {smi}", flush=True)
    del d
    torch.cuda.empty_cache()

    # 2. train_4k
    need = lm_cell_bytes(cfg, "train", M_TRAIN_BATCH, L_SEQ)
    print(f"  train_4k: cut {CONFIG.n_layers} -> {M_SMALL_LAYERS} layers, "
          f"batch 256 -> {M_TRAIN_BATCH}, seq {L_SEQ}; reckoned "
          f"{reckoned(need)}", flush=True)
    reset_launches()
    r = _lm_train(model, M_TRAIN_BATCH, L_SEQ, L_STEPS)
    n = launch_counts()
    check(not any(n.values()) and r["launches"] == 0,
          f"train steps launch no kernel ({n})")
    check(r["finite"], f"{L_STEPS} steps: every loss, m and v finite")
    for i, (w, tf) in enumerate(zip(r["walls_s"], r["tflops"])):
        print(f"  step {i + 1}: loss {r['losses'][i]:.6f}, aux "
              f"{r['auxes'][i]:.6f}, wall {w:.4f} s, "
              f"{r['tokens_per_s'][i]:.1f} tokens/s, {tf:.2f} TFLOP/s",
              flush=True)
    check(r["losses"][-1] < r["losses"][0],
          f"the loss falls: {r['losses'][0]:.6f} -> {r['losses'][-1]:.6f} "
          f"(ln {cfg.vocab} = {math.log(cfg.vocab):.3f}); peak device "
          f"{r['peak_gb']:.2f} GB")
    del model, r
    torch.cuda.empty_cache()

    # 3. float32 at the same widths
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    model = init_lm_params(f32, torch.Generator(dev).manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, CHECK_SEQ)).astype(np.int32)).to(dev)
    reset_launches()
    a, b = (make_prefill_step(f32, mode, dev)(model, toks)
            for mode in ("kernel", "reference"))
    tally(M_SMALL_LAYERS, f"float32 prefill at {CHECK_SEQ} tokens")
    err = rel_err(b.cpu().numpy(), a.cpu().numpy())
    check(err <= LM_F32_TOL,
          f"float32, {M_SMALL_LAYERS} layers: prefill kernel within "
          f"{LM_F32_TOL} max-relative of reference ({err:.3e})")
    roundtrip(model, LM_F32_TOL, tally)
    del model, a, b, toks
    torch.cuda.empty_cache()

    # 4. remat on vs off
    one = dataclasses.replace(CONFIG, n_layers=1)
    model = init_lm_params(one, torch.Generator(dev).manual_seed(0), dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, L_SEQ)).astype(np.int32)).to(dev)
    out = {}
    for remat in (True, False):
        model.cfg = dataclasses.replace(one, remat=remat)
        torch.cuda.reset_peak_memory_stats(dev)
        out[remat] = lm_value_and_grad(model, toks)
        torch.cuda.synchronize()
        print(f"  remat {remat}: peak "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB",
              flush=True)
    (a, ga), (b, gb) = out[True], out[False]
    differ = sorted(k for k in ga if not torch.equal(ga[k], gb[k]))
    check(torch.equal(a[0], b[0]) and torch.equal(a[1][1], b[1][1])
          and not differ,
          f"1 layer, batch 1 x {L_SEQ}: remat on == off: loss "
          f"{float(a[0]):.6f}, aux {float(a[1][1]):.6f} and all {len(ga)} "
          f"gradients bitwise (differ: {differ})")
    del model, out, ga, gb
    torch.cuda.empty_cache()


def phase_m_flash(smi: str, dev) -> None:
    """The ``flash_attention`` wrapper at Mixtral's windowed shape (32 / 8
    heads of 128, window 4,096, bf16): against the plain version at
    ``M_FLASH_CHECK_SEQ`` tokens (:func:`flash_vs_plain`), then timed at
    ``PREFILL_SEQ`` tokens, the shape ``prefill_32k`` launches it at,
    against the plain version again, then timed beside the same shape
    causal, SDPA with the window's mask (checked against plain within
    2^-5) and the bound of the window's (q, k) pairs. These launches
    compare and time a kernel, and are not counted."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.mixtral_8x7b import CONFIG as cfg
    from repro_torch.kernels.flash_attention import ops

    Hq, Hkv, D, W = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.window
    q, k, v = flash_inputs(1, M_FLASH_CHECK_SEQ, Hq, Hkv, D, dev)
    flash_vs_plain(q, k, v, window=W)
    del q, k, v
    S = PREFILL_SEQ
    q, k, v = flash_inputs(1, S, Hq, Hkv, D, dev)
    plain = flash_vs_plain(q, k, v, window=W)[1]
    win_ms = time_ms(lambda: ops.flash_attention(q, k, v, True, W))
    causal_ms = time_ms(lambda: ops.flash_attention(q, k, v, True, None))
    pairs = Hq * (W * S - W * (W - 1) / 2.0)
    flops = 4.0 * D * pairs
    nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
    t_f, t_b = flops / BF16_FLOP_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    G = Hq // Hkv
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    i = torch.arange(S, device=dev)
    mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < W)
    lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    lib_err = rel_err(plain.float().cpu().numpy(),
                      lib.transpose(1, 2).float().cpu().numpy())
    del lib, plain
    check(lib_err <= 2.0 ** -5, f"SDPA with the window's mask within 2^-5 "
          f"max-relative of plain ({lib_err:.3e})")
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    print(f"  flash_attention at q {tuple(q.shape)}, k/v {tuple(k.shape)}, "
          f"window {W}: {win_ms:.4f} ms; causal {causal_ms:.4f} ms (ratio "
          f"{win_ms / causal_ms:.3f}; the window's pairs "
          f"{pairs / (Hq * S * (S + 1) / 2.0):.3f} of causal's); bound "
          f"{max(t_f, t_b):.4f} ms ({'operations' if t_f >= t_b else 'bytes'}"
          f": {flops:.4e} FLOP at the bf16 tensor-core rate {t_f:.4f} ms, "
          f"bytes {t_b:.4f} ms); SDPA with the mask {lib_ms:.4f} ms; {smi}",
          flush=True)
    del q, k, v, qt, kt, vt, mask
    torch.cuda.empty_cache()


def phase_m_deepseek(smi: str, dev, counts: dict) -> None:
    """DeepSeek-V2-236B serving at ``CONFIG`` widths, ``DS_LAYERS`` layers
    (the dense first layer and MoE ones): the parameters counted against
    the leaves (``count_params``; the reference's ``param_count`` counts
    3.63 G more), then :func:`lm_serving` with no flash launch (MLA
    attends through ``chunked_attention``) and the bf16 roundtrip within
    ``DS_ROUNDTRIP_TOL``; then decode == prefill in float32 at 2 layers
    (the dense one and an MoE one, no routing flip allowed) within
    ``LM_F32_TOL``, where only float32's rounding separates the absorbed
    decode from the materialised prefill."""
    import dataclasses

    import torch

    from repro_torch.configs.deepseek_v2_236b import CONFIG
    from repro_torch.models.lm.transformer import count_params, init_lm_params

    tally = launch_tally(counts)
    cfg = dataclasses.replace(CONFIG, n_layers=DS_LAYERS)
    m = cfg.moe
    print(f"phase M: {cfg.name} serving at its published widths (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, MLA q_lora {cfg.q_lora} / "
          f"kv_lora {cfg.kv_lora} / {cfg.qk_nope_dim}+{cfg.qk_rope_dim} / "
          f"{cfg.v_head_dim}, {m.n_experts} experts of {m.d_ff_expert} "
          f"top-{m.top_k} + {m.n_shared} shared, {m.first_dense} dense "
          f"layer of {m.d_ff_dense}, vocab {cfg.vocab}, {cfg.dtype}); cut: "
          f"{CONFIG.n_layers} -> {DS_LAYERS} layers", flush=True)
    t0 = time.perf_counter()
    model = init_lm_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    check(n == count_params(cfg) == DS_PARAMS,
          f"{n:,} parameters == the leaves {DS_PARAMS:,} (the reference's "
          f"param_count() says {cfg.param_count():,}; {gb(model):.2f} GB; "
          f"made in {time.perf_counter() - t0:.1f} s)")
    lm_serving(model, tally, smi, DS_ROUNDTRIP_TOL)
    del model
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(CONFIG, n_layers=M_SMALL_LAYERS,
                              dtype=torch.float32)
    model = init_lm_params(f32, torch.Generator(dev).manual_seed(0), dev)
    roundtrip(model, LM_F32_TOL, tally)
    del model
    torch.cuda.empty_cache()


def phase_m(smi: str, dev) -> dict:
    """Phase M: MoE and MLA serving, Mixtral training, both MoE
    ``SMOKE``s card vs CPU. Returns each kernel's launches over its runs
    (the flash wrapper's comparison launches left out)."""
    counts = dict(NO_LAUNCHES)
    for part in (lambda: phase_m_mixtral(smi, dev, counts),
                 lambda: phase_m_flash(smi, dev),
                 lambda: phase_m_small(smi, dev, counts),
                 lambda: phase_m_deepseek(smi, dev, counts),
                 lambda: phase_l_card_vs_cpu(
                     dev, ("mixtral-8x7b", "deepseek-v2-236b"))):
        t0 = time.perf_counter()
        part()
        print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    return counts


# ----------------------------------------------------------------- phase K
# the CAGNET step at ogb_products: steps, and step 1's loss against the
# port's full_graph_loss (relative)
K_STEPS = 3
# phase N: the production-mesh cells traced in processes of their own
N_CELLS = (("graphsage-reddit", "ogb_products"),
           ("phi3-medium-14b", "prefill_32k"))
N_SECONDS = 60
K_LOSS_TOL = 1e-5
# the R-MAT quadrant law of kronecker_graph
K_RMAT = (0.57, 0.19, 0.19)
# halo step vs full_graph_loss (absolute), split-KV vs the plain decode
K_HALO_TOL = 1e-5
K_KV_TOL = 1e-5
# card vs CPU: losses (relative) and AdamW's m (max-relative a leaf)
K_NODES = 4096
K_CMP_TOL = 1e-4


def rmat_edges(n_nodes: int, n_edges: int, gen, dev):
    """``n_edges`` R-MAT edges on the card from the generator ``gen``: at
    each of ``ceil(log2 n_nodes)`` bit levels one uniform draw picks the
    quadrant with ``kronecker_graph``'s probabilities (a, b, c, 1 - a - b -
    c) for the row (source) and column (destination) bits; ids mod
    ``n_nodes``. Self loops and repeats are kept (the cell's edge count is
    exact); sorted by destination. Returns int32 ``(src, dst)``."""
    import torch

    a, b, c = K_RMAT
    src = torch.zeros(n_edges, dtype=torch.int64, device=dev)
    dst = torch.zeros(n_edges, dtype=torch.int64, device=dev)
    for lvl in range(math.ceil(math.log2(max(n_nodes, 2)))):
        r = torch.rand(n_edges, generator=gen, device=dev)
        row = r >= a + b
        col = torch.where(row, r >= a + b + c, r >= a)
        src += row.long() << lvl
        dst += col.long() << lvl
        del r, row, col
    src %= n_nodes
    dst %= n_nodes
    dst, order = torch.sort(dst, stable=True)
    return src[order].int(), dst.int()


def _k_m_err(ma: dict, mb: dict) -> float:
    """The largest max-relative difference between two ``m`` trees, leaf
    by leaf (``mb`` the yardstick)."""
    return max(rel_err(mb[k].cpu().numpy(), ma[k].cpu().numpy()) for k in mb)


def phase_k_registry(dev) -> None:
    """Every registered arch's ``smoke()`` on the card, then the train
    launcher's ``--list`` and ``--arch graphsage-reddit --smoke``."""
    import contextlib
    import io

    from repro_torch.configs import REGISTRY, list_cells
    from repro_torch.launch.train import main as train_main

    for name, arch in REGISTRY.items():
        r = arch.smoke(device=dev)
        ok = r["finite"] and r["grad_norm"] > 0
        if arch.family == "recsys":
            ok = ok and r["kernel_matches_reference"] and r["launches_ok"]
        check(ok, f"{name} smoke on the card: loss {r['loss']:.6f}, "
                  f"grad_norm {r['grad_norm']:.6g}, finite")
    check(len(list_cells()) == 40 and len(REGISTRY) == 11,
          f"list_cells(): {len(list_cells())} assigned cells (40) of "
          f"{len(REGISTRY)} registered archs (11), "
          f"{len(list_cells(assigned_only=False))} cells in all")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_main(["--list"])
    names = [line.split()[0] for line in out.getvalue().splitlines()]
    check(names == list(REGISTRY),
          f"launch.train --list: one line per registered arch {names}")
    try:
        train_main(["--arch", "graphsage-reddit", "--smoke"])
        code = None
    except SystemExit as e:
        code = e.code
    check(code == 0, f"launch.train --arch graphsage-reddit --smoke on the "
                     f"card: exit {code}")


def _k_steps(fn, params, opt, args, dev):
    """``K_STEPS`` calls of a train step; (losses, walls s, peak GB)."""
    import torch

    from repro_torch.launch.train import _reset_peak

    _reset_peak(dev)
    losses, walls = [], []
    for _ in range(K_STEPS):
        t0 = time.perf_counter()
        params, opt, loss = fn(params, opt, *args)
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    return losses, walls, torch.cuda.max_memory_allocated(dev) / 1e9


def phase_k_cagnet(mesh, smi: str, dev) -> dict:
    """``graphsage-reddit`` x ``ogb_products``: the registry's CAGNET
    build (sharded, per-layer remat) at the cell's full size and widths,
    ``K_STEPS`` steps on R-MAT edges made on the card; step 1's loss
    against ``full_graph_loss`` of the same inputs. Returns the bytes of
    the step's arguments, the peak device GB and the walls (phase N)."""
    import torch

    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.models.gnn.layers import (
        LocalTopo, full_graph_loss, get_gnn,
    )
    from repro_torch.optim import adamw_init

    s = GNN_SHAPES["ogb_products"]
    b = REGISTRY["graphsage-reddit"].build("ogb_products", mesh)
    dims = b.meta["dims"]
    n, e = b.args[2].shape[0], b.args[3].shape[0]
    check((n, e, dims) == (s["n_nodes"], s["n_edges"], [100, 128, 47]),
          f"graphsage-reddit x ogb_products build: {n} nodes, {e} edges, "
          f"widths {dims}")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    src, dst = rmat_edges(n, e, gen, dev)
    x = torch.randn((n, dims[0]), generator=gen, device=dev).mul_(0.1)
    labels = torch.randint(0, dims[-1], (n,), generator=gen, device=dev,
                           dtype=torch.int32)
    ew = torch.ones(e, device=dev)
    deg = torch.bincount(dst, minlength=n).clamp_min_(1).float()
    params = get_gnn("sage").init(torch.Generator().manual_seed(0), dims[0],
                                  dims[1], dims[-1], len(dims) - 1,
                                  device=dev)
    torch.cuda.synchronize(dev)
    print(f"  CAGNET inputs on the card (R-MAT edges, features, labels): "
          f"{time.perf_counter() - t0:.3f} s; max in-degree "
          f"{int(deg.max())}", flush=True)
    opt = adamw_init(params)
    data = (x, src, dst, ew, deg, labels)
    arg_bytes = sum(t.nbytes for t in [*params.state_dict().values(),
                                       *opt["m"].values(), *opt["v"].values(),
                                       opt["step"], *data])
    losses, walls, peak = _k_steps(b.fn, params, opt, data, dev)
    print(f"  CAGNET step (graphsage-reddit x ogb_products, {n} nodes, {e} "
          f"edges, widths {dims}, remat): walls {[round(w, 4) for w in walls]}"
          f" s, losses {losses}, peak device {peak:.2f} GB ({smi})",
          flush=True)
    topo = LocalTopo(
        src=src, dst=dst, n_dst=n, edge_weight=ew, edge_mask=ew,
        in_deg=deg, dst_self=torch.arange(n, dtype=torch.int32, device=dev),
        n_real_edges=e)
    with torch.no_grad():
        want = float(full_graph_loss(get_gnn("sage"), params, x, topo,
                                     labels))
    err = abs(losses[0] - want) / abs(want)
    check(all(math.isfinite(v) for v in losses) and err <= K_LOSS_TOL,
          f"CAGNET step 1's loss {losses[0]!r} within {K_LOSS_TOL} of "
          f"full_graph_loss {want!r} ({err:.3e}); every step finite")
    del x, src, dst, ew, deg, labels, topo, data, opt
    torch.cuda.empty_cache()
    return dict(arg_bytes=arg_bytes, peak_gb=peak, walls=walls)


def mfg_tensors(hops, d_feat: int, classes: int, seed: int, dev):
    """One MFG group of the given hop sizes (innermost first), numpy seed
    ``seed``: each destination takes ``n_edges / n_dst`` (the fan-out)
    sources uniform over its hop's sources, every edge real, features
    normal x 0.1, labels uniform."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    x = t((rng.standard_normal((1, hops[0][0], d_feat)) * 0.1)
          .astype(np.float32))
    flat = []
    for n_src, n_dst, n_e in hops:
        f = n_e // n_dst
        flat.append((
            t(rng.integers(0, n_src, (1, n_e)).astype(np.int32)),
            t(np.repeat(np.arange(n_dst, dtype=np.int32), f)[None]),
            t(np.ones((1, n_e), np.float32)),
            t(np.full((1, n_dst), float(f), np.float32)),
        ))
    y = t(rng.integers(0, classes, (1, hops[-1][1])).astype(np.int32))
    return x, tuple(flat), y


def molecule_tensors(B: int, n: int, E: int, d_feat: int, classes: int,
                     seed: int, dev):
    """``B`` random graphs of ``n`` nodes and ``E`` edges (numpy seed
    ``seed``): the first ``n`` edges one into each node (every atom has a
    bond), the rest between uniform nodes; features normal x 0.1, degree
    the in-edge count, labels uniform."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, (B, E)).astype(np.int32)
    dst = rng.integers(0, n, (B, E)).astype(np.int32)
    dst[:, :n] = np.arange(n)
    deg = np.stack([np.bincount(d, minlength=n) for d in dst])
    arrays = ((rng.standard_normal((B, n, d_feat)) * 0.1).astype(np.float32),
              src, dst, np.ones((B, E), np.float32), deg.astype(np.float32),
              rng.integers(0, classes, B).astype(np.int32))
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


def phase_k_mfg_batched(mesh, smi: str, dev) -> None:
    """``graphsage-reddit`` x ``minibatch_lg`` (the MFG step at the cell's
    hop sizes) and ``pna`` x ``molecule`` (the batched step), each from
    the registry's build, ``K_STEPS`` steps."""
    from repro_torch.configs import REGISTRY
    from repro_torch.configs.base import GNN_SHAPES, mfg_hop_sizes
    from repro_torch.models.gnn.layers import get_gnn
    from repro_torch.optim import adamw_init

    import torch

    s = GNN_SHAPES["minibatch_lg"]
    b = REGISTRY["graphsage-reddit"].build("minibatch_lg", mesh)
    dims = b.meta["dims"]
    hops = mfg_hop_sizes(len(dims) - 1, s["batch_nodes"], s["fanout"],
                         s["n_nodes"], 1)
    check(hops == [(180224, 16384, 163840), (16384, 1024, 15360)]
          and tuple(b.args[2].shape) == (1, 180224, 602),
          f"graphsage-reddit x minibatch_lg build: hops {hops}, widths "
          f"{dims}")
    params = get_gnn("sage").init(torch.Generator().manual_seed(0), dims[0],
                                  dims[1], dims[-1], len(dims) - 1,
                                  device=dev)
    x, flat, y = mfg_tensors(hops, dims[0], dims[-1], 0, dev)
    losses, walls, peak = _k_steps(b.fn, params, adamw_init(params),
                                   (x, flat, y), dev)
    check(all(math.isfinite(v) for v in losses),
          f"MFG step (graphsage-reddit x minibatch_lg, widths {dims}): "
          f"walls {[round(w, 4) for w in walls]} s, losses {losses}, peak "
          f"device {peak:.2f} GB ({smi})")
    s = GNN_SHAPES["molecule"]
    b = REGISTRY["pna"].build("molecule", mesh)
    dims = b.meta["dims"]
    check(dims == [32, 75, 75, 75, 16]
          and tuple(b.args[2].shape) == (128, 30, 32),
          f"pna x molecule build: 128 graphs of 30 nodes, widths {dims}")
    params = get_gnn("pna").init(torch.Generator().manual_seed(0), dims[0],
                                 dims[1], dims[-1], len(dims) - 1,
                                 device=dev)
    args = molecule_tensors(s["batch"], s["n_nodes"], s["n_edges"],
                            dims[0], dims[-1], 0, dev)
    losses, walls, peak = _k_steps(b.fn, params, adamw_init(params), args,
                                   dev)
    check(all(math.isfinite(v) for v in losses),
          f"batched step (pna x molecule, widths {dims}): walls "
          f"{[round(w, 4) for w in walls]} s, losses {losses}, peak device "
          f"{peak:.3f} GB ({smi})")


def phase_k_small(mesh, dev) -> None:
    """The partitioned-halo step (one partition) against
    ``full_graph_loss`` of the reordered graph, and split-KV decoding
    against the plain decode, at world size 1 on the card."""
    import numpy as np
    import torch

    from repro_torch.core.plan import remap_edge_weight
    from repro_torch.distributed.collectives import (
        decode_attention_ref, make_split_kv_decode,
    )
    from repro_torch.distributed.gnn_parallel import (
        build_partitioned_data, make_partitioned_train_step,
    )
    from repro_torch.graph import gcn_norm_coeffs, kronecker_graph
    from repro_torch.graph.csr import add_self_loops
    from repro_torch.graph.synthetic import random_features, random_labels
    from repro_torch.models.gnn.layers import (
        full_graph_loss, full_graph_topo, get_gnn,
    )
    from repro_torch.optim import adamw_init

    g = add_self_loops(kronecker_graph(K_NODES, 8, seed=0))
    ew = gcn_norm_coeffs(g)
    data, n_local, n_halo, ro = build_partitioned_data(
        g, np.zeros(g.n_nodes, np.int32), 1, ew)
    x = random_features(g.n_nodes, 32, 0)[ro.perm]
    y = random_labels(g.n_nodes, 8, 0)[ro.perm]
    params = get_gnn("gcn").init(torch.Generator().manual_seed(0), 32, 16, 8,
                                 2, device=dev)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    step = make_partitioned_train_step("gcn", n_local, n_halo, mesh)
    _, _, loss = step(params, adamw_init(params), t(x),
                      *[t(data[k][0]) for k in ("lsrc", "ldst", "lew",
                                                "hsrc", "hdst", "hew",
                                                "halo", "deg")], t(y))
    topo = full_graph_topo(ro.graph.indptr, ro.graph.indices, g.n_nodes,
                           remap_edge_weight(g, ro, ew), device=dev)
    with torch.no_grad():
        want = float(full_graph_loss(get_gnn("gcn"), params, x, topo, y))
    err = abs(float(loss) - want)
    check(err <= K_HALO_TOL,
          f"halo step (gcn, {g.n_nodes} nodes, one partition) loss "
          f"{float(loss)!r} within {K_HALO_TOL} of full_graph_loss "
          f"{want!r} ({err:.3e})")
    rng = np.random.default_rng(0)
    q, k, v = (t(rng.standard_normal(sh).astype(np.float32)) for sh in
               ((2, 1, 8, 16), (2, 64, 2, 16), (2, 64, 2, 16)))
    for window in (None, 16):
        got = make_split_kv_decode(mesh, ("model",), window=window)(
            q, k, v, 50)
        err = float((got - decode_attention_ref(q, k, v, 50,
                                                window=window)).abs().max())
        check(err <= K_KV_TOL,
              f"split-KV decode (window {window}) within {K_KV_TOL} of the "
              f"plain decode ({err:.3e})")


def phase_k_card_vs_cpu(gloo, dev) -> None:
    """The CAGNET (sage, on ``kronecker_graph(K_NODES, 8)`` plus self
    loops), MFG (sage) and batched (pna) steps on the card (nccl) and on
    the CPU (gloo) from the same inputs: losses within ``K_CMP_TOL``
    relative, AdamW's ``m`` within ``K_CMP_TOL`` max-relative a leaf."""
    import numpy as np
    import torch

    from repro_torch.configs.base import mfg_hop_sizes
    from repro_torch.distributed import gnn_parallel as gp
    from repro_torch.graph import gcn_norm_coeffs, kronecker_graph
    from repro_torch.graph.csr import add_self_loops
    from repro_torch.graph.synthetic import random_features, random_labels
    from repro_torch.models.gnn.layers import get_gnn
    from repro_torch.optim import adamw_init

    cpu = torch.device("cpu")
    g = add_self_loops(kronecker_graph(K_NODES, 8, seed=0))
    n = g.n_nodes
    src, dst = g.edge_index()
    cagnet = (random_features(n, 64, 0), src.astype(np.int32),
              dst.astype(np.int32), gcn_norm_coeffs(g).astype(np.float32),
              np.maximum(g.in_degrees(), 1).astype(np.float32),
              random_labels(n, 8, 0))
    hops = mfg_hop_sizes(2, 256, (15, 10), n, 1)
    cases = [
        ("CAGNET sage", "sage", [64, 32, 8],
         lambda grp: gp.make_fullgraph_train_step("sage", n, group=grp),
         lambda d: tuple(torch.from_numpy(a).to(d) for a in cagnet)),
        ("MFG sage", "sage", [64, 32, 8],
         lambda grp: gp.make_mfg_train_step("sage", hops, group=grp),
         lambda d: mfg_tensors(hops, 64, 8, 1, d)),
        ("batched pna", "pna", [32, 75, 75, 75, 16],
         lambda grp: gp.make_batched_graph_train_step("pna", 30, group=grp),
         lambda d: molecule_tensors(128, 30, 64, 32, 16, 1, d)),
    ]
    for label, model, dims, make, inputs in cases:
        runs = []
        for d, grp in ((dev, None), (cpu, gloo)):
            params = get_gnn(model).init(torch.Generator().manual_seed(0),
                                         dims[0], dims[1], dims[-1],
                                         len(dims) - 1, device=d)
            _, o, loss = make(grp)(params, adamw_init(params), *inputs(d))
            runs.append((float(loss), o["m"]))
        (lc, mc), (lh, mh) = runs
        le = abs(lc - lh) / abs(lh)
        me = _k_m_err(mc, mh)
        check(le <= K_CMP_TOL and me <= K_CMP_TOL,
              f"{label} step, card (nccl) vs CPU (gloo): loss {lc!r} vs "
              f"{lh!r} ({le:.3e}), m max-relative {me:.3e} (within "
              f"{K_CMP_TOL})")


def expandable_segments(on: bool) -> None:
    """The caching allocator's ``expandable_segments`` setting, from here
    on (the setter is deprecated in favour of a private one in recent
    releases; the warning is silenced)."""
    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        torch.cuda.memory._set_allocator_settings(
            f"expandable_segments:{on}")


def phase_k(smi: str, dev) -> dict:
    """Phase K: the registry and the distributed steps in a process group
    of one rank (``nccl``, a file store; a ``gloo`` group beside it for
    the CPU runs). Returns each kernel's launches over its runs (the
    two-tower smoke's)."""
    import gc
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.mesh import init_host_group, make_host_mesh

    gc.collect()
    torch.cuda.empty_cache()
    # the CAGNET step's (E, 128) messages and their gradients are 31.7 GB
    # each: let the caching allocator grow segments in place (with fixed
    # segments, layer 1's backward finds the 32 GB it needs free only in
    # pieces split by the forward's small tensors, and runs out of memory)
    expandable_segments(True)
    store = tempfile.mkdtemp()
    backend = init_host_group(os.path.join(store, "pg"), 0, 1,
                              backend="nccl")
    try:
        gloo = dist.new_group(backend="gloo")
        mesh = make_host_mesh(1, 1)
        print(f"phase K: the registry and distributed/ over a {backend} "
              f"group of {dist.get_world_size()} rank, mesh {mesh}",
              flush=True)
        reset_launches()
        phase_k_registry(dev)
        launches = dict(NO_LAUNCHES, **launch_counts())
        cagnet = {}
        for part in (lambda: cagnet.update(phase_k_cagnet(mesh, smi, dev)),
                     lambda: phase_k_mfg_batched(mesh, smi, dev),
                     lambda: phase_k_small(mesh, dev),
                     lambda: phase_k_card_vs_cpu(gloo, dev)):
            t0 = time.perf_counter()
            reset_launches()
            part()
            n = launch_counts()
            launches["segment_sum"] += n["segment_sum"]
            check(not any(n[k] for k in TABLE),
                  f"no kernel of the TPU table launched by the distributed "
                  f"steps ({n['segment_sum']} segment_sum launches, "
                  f"{time.perf_counter() - t0:.1f} s)")
    finally:
        dist.destroy_process_group()
        expandable_segments(False)
    return launches, cagnet


# ----------------------------------------------------------------- phase N
def dry_trace(arch: str, shape: str, dev, **build_kw):
    """The dry run's record of one cell on a placeholder ``(1, 1)`` mesh
    for the card (a ``fake`` group of one rank, torn down after), and its
    ``Built``."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib

    meshlib.init_placeholder_group(1)
    try:
        mesh = meshlib.make_mesh((1, 1), "cuda")
        built = get_arch(arch).build(shape, mesh, **build_kw)
        t0 = time.perf_counter()
        rec = dryrun.trace_built(built, mesh, dev)
        rec["seconds"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    return built, rec


def predicted_gb(rec: dict) -> float:
    m = rec["memory"]
    return (m["argument_bytes"] + m["output_bytes"] - m["alias_bytes"]
            + m["temp_bytes"]) / 1e9


def phase_n_cagnet(cagnet: dict, dev) -> None:
    """N1: the CAGNET cell phase K ran, traced."""
    _, rec = dry_trace("graphsage-reddit", "ogb_products", dev)
    got = rec["memory"]["argument_bytes"]
    check(got == cagnet["arg_bytes"],
          f"N1 graphsage-reddit x ogb_products on (1, 1): predicted "
          f"argument bytes {got} == phase K's arguments' "
          f"{cagnet['arg_bytes']} (trace {rec['seconds']:.1f} s)")
    peak = predicted_gb(rec)
    print(f"  N1: predicted peak {peak:.3f} GB vs phase K's "
          f"{cagnet['peak_gb']:.3f} GB (ratio {peak / cagnet['peak_gb']:.3f}"
          f"); FLOPs {rec['hlo_flops']:.4g}, bytes {rec['hlo_bytes']:.4g}, "
          f"roofline {rec['roofline']} vs phase K's step walls "
          f"{[round(w, 4) for w in cagnet['walls']]} s", flush=True)


def phase_n_mixtral(dev) -> None:
    """N2: ``long_500k`` at 2 layers, traced and run once."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.train import _reset_peak
    from repro_torch.models.lm.steps import make_decode_step
    from repro_torch.models.lm.transformer import (
        init_kv_cache, init_lm_params,
    )

    built, rec = dry_trace("mixtral-8x7b", "long_500k", dev,
                           n_layers=M_SMALL_LAYERS)
    cfg = built.args[0].cfg
    model = init_lm_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    cache = init_kv_cache(cfg, 1, M_LONG_SEQ, device=dev)
    token = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    # the build's cache_len is a 0-d int32 tensor; the step takes an int
    want = sum(p.nbytes for p in model.parameters()) + sum(
        c.nbytes for c in cache.values()) + token.nbytes + 4
    got = rec["memory"]["argument_bytes"]
    check(got == want, f"N2 mixtral-8x7b x long_500k at {M_SMALL_LAYERS} "
          f"layers on (1, 1): predicted argument bytes {got} == the real "
          f"step's {want} (trace {rec['seconds']:.1f} s)")
    step = make_decode_step(cfg, device=dev)
    _reset_peak(dev)
    with FlopCounterMode(display=False) as fc:
        t0 = time.perf_counter()
        logits, _ = step(model, cache, token, M_LONG_SEQ)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    check(bool(torch.isfinite(logits).all()), "N2: the real step's logits "
          "finite")
    n = fc.get_total_flops()
    check(rec["hlo_flops"] == n, f"N2: the trace's FLOPs "
          f"{rec['hlo_flops']:.6g} == FlopCounterMode's count of the real "
          f"decode step on the card {n:.6g}")
    print(f"  N2: predicted peak {predicted_gb(rec):.3f} GB vs the real "
          f"step's {peak:.3f} GB (phase M's 8-step run: 13.12 GB, PERF.md); "
          f"step wall {wall * 1e3:.2f} ms; roofline {rec['roofline']}",
          flush=True)
    del model, cache, logits
    torch.cuda.empty_cache()


def phase_n_production(dev) -> None:
    """N3: two production-mesh cells, each in a process of its own (the
    placeholder group of 256 ranks cannot share a process with phase K's
    nccl group)."""
    import tempfile

    from repro_torch.launch import dryrun

    out = tempfile.mkdtemp()
    procs = []
    for arch, shape in N_CELLS:
        cmd, env = dryrun.command(arch, shape, "single", "cuda", out)
        procs.append((arch, shape, subprocess.Popen(
            cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    for arch, shape, p in procs:
        text = p.communicate(timeout=N_SECONDS * 3)[0]
        lines = [ln for ln in text.splitlines() if ln.startswith("[")]
        for ln in lines:
            print(f"  N3: {ln}", flush=True)
        check(p.returncode == 0 and any(ln.startswith("[ok]")
                                        for ln in lines),
              f"N3: {arch} x {shape} on the 16x16 placeholder mesh ends ok "
              f"(exit {p.returncode}{'' if lines else ': ' + text[-2000:]})")
        with open(os.path.join(out, f"{arch}__{shape}__16x16.json")) as f:
            rec = json.load(f)
        print(f"  N3: {arch} x {shape}: per-device peak "
              f"{predicted_gb(rec):.3f} GB, FLOPs {rec['hlo_flops']:.4g}, "
              f"collective bytes by dim {rec['collective_bytes_by_dim']}, "
              f"roofline {rec['roofline']}", flush=True)


def phase_n(smi: str, dev, cagnet: dict, tiers: dict) -> None:
    """Phase N: the dry run held against the steps phases K and M run."""
    from repro_torch.launch import mesh as meshlib

    print(f"phase N: the dry run; {smi}; roofline constants (H100 SXM5 "
          f"datasheet): bf16 {meshlib.CHIP_PEAK_FLOPS:.4g} FLOP/s, float32 "
          f"{meshlib.CHIP_PEAK_FLOPS_F32:.4g} FLOP/s, HBM "
          f"{meshlib.CHIP_HBM_BW / 1e9:.0f} GB/s (phase J measured "
          f"{tiers['hbm'] / 1e9:.1f} GB/s), NVLink "
          f"{meshlib.NVLINK_BW / 1e9:.0f} GB/s, NIC "
          f"{meshlib.NIC_BW / 1e9:.0f} GB/s", flush=True)
    t0 = time.perf_counter()
    phase_n_cagnet(cagnet, dev)
    phase_n_mixtral(dev)
    phase_n_production(dev)
    took = time.perf_counter() - t0
    check(took <= N_SECONDS, f"phase N within {N_SECONDS} s ({took:.1f} s)")


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
    baseline, tiers = phase_j(graph, fused_run, smi, dev)
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
    t0 = time.perf_counter()
    lm_train = phase_l(smi, dev)
    print(f"phase L: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    moe_mla = phase_m(smi, dev)
    print(f"phase M: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    registry, cagnet = phase_k(smi, dev)
    print(f"phase K: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_n(smi, dev, cagnet, tiers)
    print(f"phase N: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"all phases: {time.perf_counter() - t_all:.1f} s", flush=True)

    kernels = []
    for name, r in results.items():
        # each kernel's launches over the serving, GCN training, GAT
        # training, other families' training, phase J's runs, two-tower
        # serving and training, LM serving, phase L's prefills at the other
        # dense ids' widths, phase M's MoE serving, phase K's registry
        # smokes and distributed steps and bsr_spmm aggregate paths, every
        # count read right after its runs
        n = sum(serving[m][name] + training[m][name] for m in MODES)
        n += sum(counts[name] for counts in gat.values())
        n += sum(counts[name] for counts in families.values())
        n += baseline[name]
        n += tt_serving[name] + tt_training[name] + lm["launches"][name]
        n += lm_train[name] + moe_mla[name]
        n += registry[name]
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
