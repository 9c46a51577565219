"""GCNII (``get_gnn("gcnii")``) in the port, on the CPU, against the plain
whole-graph GCNII of ``tests/plain_gcnii.py``.

A 300-node Kronecker graph with self-loops, 4 switching-aware partitions,
dims ``[24] + [16] * 5 + [5]``: the dense input layer, 4 convolutions, the
dense output layer. Properties:

- ``beta_l = ln(0.4 / l + 1)`` and ``alpha = 0.1`` on every convolution,
  plain floats that survive a build on the meta device;
- the port's whole-graph loss and every gradient in float64 against the
  plain reference;
- one ``SSOEngine`` epoch (regather, a cache that spills ``H^0`` and grad
  1, pipeline depth 0 and 2, dispatch ``reference`` and ``kernel``)
  against the plain reference: the loss and every leaf's gradient,
  ``0.lin.*`` included, whose gradient reaches it only through ``∇H^0``;
  ``kernel`` == ``reference`` and pipelined == serial bitwise;
- ``alpha = 0`` and ``beta = 1`` each fail both comparisons;
- the residual's counters and loop state read above 0 on a spilling epoch
  and the loop's states still close the epoch's wall; the tracer shows
  ``residual`` spans;
- snapshot mode refuses the family; ``OffloadedInference`` runs it;
- the benchmark's reference copy and configuration agree with these.
"""
import dataclasses
import json
import math
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import plain_gcnii as plain
from repro_torch.core.cache import HostCache
from repro_torch.core.counters import Counters
from repro_torch.core.engine import SSOEngine
from repro_torch.core.plan import build_plan
from repro_torch.core.storage import StorageTier
from repro_torch.graph.csr import add_self_loops, gcn_norm_coeffs
from repro_torch.graph.partition import switching_aware_partition
from repro_torch.graph.synthetic import (
    kronecker_graph, random_features, random_labels,
)
from repro_torch.infer import OffloadedInference
from repro_torch.models.gnn import layers as tl
from repro_torch.runtime import PipelineConfig
from repro_torch.runtime.accounting import LOOP_STATES

REPO = Path(__file__).resolve().parent.parent
DIMS = [24] + [16] * 5 + [5]
N_LAYERS = len(DIMS) - 1
N_PARTS = 4
# a cache of 64 KB: a partition's block of a 16-wide layer is ~4.8 KB, so
# one unit's blocks, H^0's and the live grad blocks do not all fit
SPILL_BYTES = 1 << 16
# float64 against float64: the port sums each destination's messages in
# edge order, the plain reference in its sparse product's order; over six
# layers that reassociation stays within a few ulp of 2**-52
F64_RTOL = 1e-10
# the engine's float32 against float64: float32 rounds each operation at
# 2**-24 (6e-8); the losses read 3e-8 and the worst leaf 6e-7 max-relative
# here, so 1e-6 and 1e-5 leave tenfold room, far below a fault's O(1)
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    g = add_self_loops(kronecker_graph(300, 6, seed=0))
    parts = switching_aware_partition(g, N_PARTS, max_iters=8, seed=0).parts
    plan = build_plan(g, parts, N_PARTS, edge_weight=gcn_norm_coeffs(g),
                      device="cpu")
    x = random_features(g.n_nodes, DIMS[0], 0)
    y = random_labels(g.n_nodes, DIMS[-1], 0)
    return g, plan, x, y


def make_params(seed=0, device="cpu"):
    return tl.get_gnn("gcnii").init(torch.Generator().manual_seed(seed),
                                    DIMS[0], DIMS[1], DIMS[-1], N_LAYERS,
                                    device=device)


def leaves(params):
    return {f"{i}.{k}": p for i, layer in enumerate(params)
            for k, p in layer.named_parameters()}


def plain_loss_grads(g, params, x, y, **kw):
    """The plain reference's loss and gradients in float64 at the port's
    weights (``kw``: its ``alpha`` and ``lam``)."""
    p64 = {k: v.detach().double().requires_grad_(True)
           for k, v in leaves(params).items()}
    adj = plain.adjacency(g.indptr, g.indices)
    loss = plain.loss(p64, torch.from_numpy(x).double(), adj,
                      torch.from_numpy(y), **kw)
    grads = torch.autograd.grad(loss, list(p64.values()))
    return loss.item(), dict(zip(p64, grads))


def gaps(loss, grads, ref_loss, ref_grads):
    """``(loss gap, worst leaf's max-relative gap)``, relative."""
    worst = max(
        float((grads[k].double() - r).abs().max() / r.abs().max())
        for k, r in ref_grads.items())
    return abs(loss - ref_loss) / abs(ref_loss), worst


def engine_grads(grads):
    return {f"{i}.{k}": v for i, d in enumerate(grads) for k, v in d.items()}


def fault(params, which):
    """Plant a fault: the initial residual left out, or the identity
    mapping left out (the whole weight taken)."""
    for layer in params:
        if isinstance(layer, tl.GCNIIConv):
            if which == "alpha0":
                layer.alpha = 0.0
            else:
                layer.beta = 1.0
    return params


def full_graph_64(g, params, x, y):
    """The port's whole-graph loss and gradients in float64 (its layers
    cast, exact float64 edge weights)."""
    p64 = [layer.double() for layer in params]
    topo = tl.full_graph_topo(g.indptr, g.indices, g.n_nodes, device="cpu")
    deg = np.maximum(np.diff(g.indptr), 1).astype(np.float64)
    dst = np.repeat(np.arange(g.n_nodes), np.diff(g.indptr))
    w = 1.0 / np.sqrt(deg[g.indices] * deg[dst])
    topo = dataclasses.replace(topo, edge_weight=torch.from_numpy(w))
    loss = tl.full_graph_loss(tl.get_gnn("gcnii"), p64,
                              torch.from_numpy(x).double(), topo, y)
    flat = leaves(p64)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.item(), dict(zip(flat, grads))


def run_engine(plan, x, y, params, depth=0, kernels="reference",
               budget=SPILL_BYTES, trace=None):
    """One epoch on a fresh engine; ``trace``: a path for its trace.
    Returns ``(loss, grads, counters, {"w"|"r": storage files written |
    read}, the tracer's events)``."""
    c = Counters()
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    names = {"w": set(), "r": set()}
    for kind, attr in (("w", "_write_rows_once"), ("r", "_read_rows_once")):
        orig = getattr(st, attr)

        def spy(name, *a, _orig=orig, _kind=kind):
            names[_kind].add(name)
            return _orig(name, *a)

        setattr(st, attr, spy)
    eng = SSOEngine(tl.get_gnn("gcnii"), plan, DIMS, st,
                    HostCache(budget, st, c), c, device="cpu",
                    pipeline=PipelineConfig(depth=depth, kernels=kernels,
                                            trace=trace))
    eng.initialize(x[plan.ro.perm])
    try:
        loss, grads = eng.run_epoch(params, y[plan.ro.perm])
        events = c.tracer.events()
        pool = eng._rt.pool
    finally:
        eng.close()
        st.close()
    assert pool.outstanding == 0
    return loss, grads, c, names, events


@pytest.fixture(scope="module")
def runs(setup):
    """Engine epochs at the seeded weights, memoised by (depth, kernels)."""
    _, plan, x, y = setup
    memo = {}

    def get(depth, kernels):
        if (depth, kernels) not in memo:
            memo[depth, kernels] = run_engine(plan, x, y, make_params(),
                                              depth, kernels)
        return memo[depth, kernels]

    return get


# ------------------------------------------------------------------ layers
def test_beta_and_alpha_follow_the_module_index():
    params = make_params()
    assert isinstance(params[0], tl.GCNIIDense)
    assert isinstance(params[-1], tl.GCNIIDense)
    for l in range(1, N_LAYERS - 1):
        assert isinstance(params[l], tl.GCNIIConv)
        assert params[l].beta == math.log(0.4 / l + 1.0)
        assert params[l].beta == plain.beta(l)
        assert params[l].alpha == 0.1 == plain.ALPHA
    assert [tl.get_gnn("gcnii").side_layer(l, N_LAYERS)
            for l in range(N_LAYERS)] == [None, 1, 1, 1, 1, None]


def test_meta_build_keeps_alpha_beta_and_the_reference_names():
    """The benchmark builds on the meta device and materialises with
    ``to_empty``: the floats survive, and the names are the reference's
    keys."""
    params = tl.get_gnn("gcnii").init(
        torch.Generator(), 1024, 256, 19, 18, device="meta").to_empty(
        device="cpu")
    assert params[16].beta == math.log(0.4 / 16 + 1.0)
    assert params[3].alpha == 0.1
    want = {"0.lin.weight": (256, 1024), "0.lin.bias": (256,),
            "17.lin.weight": (19, 256), "17.lin.bias": (19,)}
    want.update({f"{l}.w": (256, 256) for l in range(1, 17)})
    assert {k: tuple(p.shape) for k, p in leaves(params).items()} == want


def test_a_convolution_without_h0_refuses():
    params = make_params()
    ga = torch.zeros((3, 16))
    topo = tl.full_graph_topo(np.array([0, 1, 2, 3]), np.array([0, 1, 2]),
                              3, device="cpu")
    with pytest.raises(ValueError, match="H\\^0"):
        tl.gcnii_apply(params[1], ga, topo)


def test_full_graph_loss_and_grads_match_plain_float64(setup):
    g, _, x, y = setup
    params = make_params()
    ref = plain_loss_grads(g, params, x, y)
    got = full_graph_64(g, params, x, y)
    assert set(got[1]) == set(ref[1])
    loss_gap, grad_gap = gaps(*got, *ref)
    assert loss_gap <= F64_RTOL and grad_gap <= F64_RTOL, (loss_gap,
                                                            grad_gap)


# ------------------------------------------------------------------ engine
@pytest.mark.parametrize("kernels", ["reference", "kernel"])
@pytest.mark.parametrize("depth", [0, 2])
def test_engine_epoch_matches_plain(setup, runs, depth, kernels):
    g, _, x, y = setup
    ref_loss, ref_grads = plain_loss_grads(g, make_params(), x, y)
    loss, grads, c, names, _ = runs(depth, kernels)
    loss_gap, grad_gap = gaps(loss, engine_grads(grads), ref_loss, ref_grads)
    assert loss_gap <= LOSS_RTOL, loss_gap
    assert grad_gap <= GRAD_RTOL, grad_gap
    assert set(engine_grads(grads)) == set(ref_grads)
    # the cache spilled: H^0 re-read from storage for the residual, grad 1
    # written out and read back while the convolutions added into it
    assert c.residual_read_bytes > 0
    assert "grad1" in names["w"] and "grad1" in names["r"]


@pytest.mark.parametrize("kernels,depth",
                         [("kernel", 0), ("reference", 2), ("kernel", 2)])
def test_engine_bitwise_across_routes(runs, kernels, depth):
    """``kernel`` == ``reference`` and pipelined == serial, bit for bit."""
    base_loss, base, *_ = runs(0, "reference")
    loss, grads, *_ = runs(depth, kernels)
    assert loss == base_loss
    for a, b in zip(grads, base):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("which", ["alpha0", "beta1"])
@pytest.mark.parametrize("check", ["full_graph", "engine"])
def test_faults_fail_the_comparison(setup, check, which):
    g, plan, x, y = setup
    ref_loss, ref_grads = plain_loss_grads(g, make_params(), x, y)
    params = fault(make_params(), which)
    if check == "full_graph":
        loss_gap, grad_gap = gaps(*full_graph_64(g, params, x, y),
                                  ref_loss, ref_grads)
        assert loss_gap > F64_RTOL or grad_gap > F64_RTOL
    else:
        loss, grads, *_ = run_engine(plan, x, y, params)
        loss_gap, grad_gap = gaps(loss, engine_grads(grads), ref_loss,
                                  ref_grads)
        assert loss_gap > LOSS_RTOL or grad_gap > GRAD_RTOL


# ----------------------------------------------------------------- tracing
@pytest.mark.parametrize("depth", [0, 2])
def test_residual_accounting_on_a_spilling_epoch(setup, tmp_path, depth):
    """The residual's counters and loop state read above 0; the loop's
    states plus its unit waits close the epoch's wall within 10%, as for
    GCN (``test_torch_loop_accounting.py``); with the tracer on,
    ``residual`` and ``loop:residual`` spans."""
    _, plan, x, y = setup
    *_, c, _, events = run_engine(plan, x, y, make_params(), depth=depth,
                                  trace=str(tmp_path / "trace.json"))
    assert c.residual_read_bytes > 0
    # 300 rows for each of the 4 convolutions, forward and backward
    assert c.residual_rows == 300 * 4 * 2
    assert c.loop_residual_ns > 0
    assert {"residual", "loop:residual"} <= {e["name"] for e in events}
    states = {s: getattr(c, f"loop_{s}_ns") / 1e9 for s in LOOP_STATES}
    wait = sum(v for k, v in c.stage_stall_seconds.items()
               if k.startswith("compute_wait"))
    wall = c.phase_seconds["epoch"]
    assert all(v >= 0 for v in states.values())
    assert abs(sum(states.values()) + wait - wall) <= 0.10 * wall, (
        wall, states, wait)


# ------------------------------------------------------ snapshot, inference
def test_snapshot_mode_refuses_gcnii(setup):
    _, plan, _, _ = setup
    c = Counters()
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    try:
        with pytest.raises(ValueError, match="gcnii"):
            SSOEngine(tl.get_gnn("gcnii"), plan, DIMS, st,
                      HostCache(SPILL_BYTES, st, c), c, mode="snapshot",
                      device="cpu")
    finally:
        st.close()


def _infer(plan, x, params, depth, kernels):
    c = Counters()
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    eng = OffloadedInference(
        tl.get_gnn("gcnii"), plan, DIMS, st, HostCache(SPILL_BYTES, st, c),
        c, pipeline=PipelineConfig(depth=depth, kernels=kernels),
        device="cpu")
    try:
        eng.initialize(x[plan.ro.perm])
        name = eng.run(params)
        out = st.read_rows(name, 0, plan.n_nodes)
        files = [f"act{l}" for l in range(N_LAYERS) if st.exists(f"act{l}")]
    finally:
        eng.close()
        st.close()
    return out, files, c


def test_offloaded_inference_runs_gcnii(setup):
    """Every node's logits against the plain reference (float32 against
    float64, the engine's tolerance), bitwise across routes; H^0's file
    outlives the convolutions that read it, and goes after them."""
    g, plan, x, _ = setup
    params = make_params()
    p64 = {k: v.detach().double() for k, v in leaves(params).items()}
    want = plain.forward(p64, torch.from_numpy(x).double(),
                         plain.adjacency(g.indptr, g.indices)).numpy()
    base, files, c = _infer(plan, x, params, 0, "reference")
    assert files == ["act0"]
    assert c.residual_rows == 300 * 4
    got = np.empty_like(base)
    got[plan.ro.perm] = base
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= GRAD_RTOL, err
    for depth, kernels in ((2, "reference"), (0, "kernel"), (2, "kernel")):
        out, _, _ = _infer(plan, x, params, depth, kernels)
        np.testing.assert_array_equal(out, base)


# --------------------------------------------------------------- benchmark
def test_benchmark_reference_copy_agrees_with_plain(setup):
    sys.path.insert(0, str(REPO))
    try:
        from perfbench.reference import Graph
        from perfbench.reference import gcnii as bench
    finally:
        sys.path.remove(str(REPO))
    g, _, x, _ = setup
    params = make_params()
    p64 = {k: v.detach().double() for k, v in leaves(params).items()}
    config = {"dims": DIMS, "alpha": 0.1, "lambda": 0.4}
    layered = [dict() for _ in range(N_LAYERS)]
    for k, v in p64.items():
        i, name = k.split(".", 1)
        layered[int(i)][name] = v
    xt = torch.from_numpy(x).double()
    got = bench.forward(layered, xt, Graph.from_csr(g.indptr, g.indices,
                                                    "cpu"), config)
    want = plain.forward(p64, xt, plain.adjacency(g.indptr, g.indices))
    torch.testing.assert_close(got, want, rtol=F64_RTOL, atol=0)
    assert [k for k, _, _ in bench.param_init(config)] == list(p64)


def test_benchmark_config_holds_the_spec_defaults():
    cfg = json.loads((REPO / "perfbench" / "configs" /
                      "gcnii-igbm-16l.json").read_text())
    assert cfg["model"] == "gcnii"
    assert cfg["alpha"] == tl.GCNII_ALPHA == cfg["published"]["alpha"]
    assert cfg["lambda"] == tl.GCNII_LAMBDA == cfg["published"]["lambda"]
    assert cfg["dims"] == [1024] + [256] * 17 + [19]
    # 18 modules: the dense input layer, 16 convolutions, the dense output
    assert len(cfg["dims"]) - 3 == cfg["published"]["n_layers"] == 16
