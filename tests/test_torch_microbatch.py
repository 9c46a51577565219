"""The port's micro-batch baseline (``repro_torch.core.microbatch``) and
neighbour sampler (``repro_torch.graph.sampler``) against the reference, on
the CPU.

- ``build_full_mfg`` (the port's vectorised hop function) and
  ``NeighborSampler`` emit MFGs bitwise the reference's: every array of
  every hop equal with its dtype, for the same graph, seeds and sampler
  seed (two successive draws, so the sampler's RNG stream matches too);
- ``microbatch_grads`` for each of the six families on the shared
  ``tiny_graph`` (GCN edge weights, dims [16, 24, 8], reference weights
  from ``PRNGKey(0)`` converted with ``params_from_jax``): loss within
  1e-4 and every gradient within 1e-4 max-relative of the reference's
  ``microbatch_grads`` over 2 micro-batches (float32 reassociation across
  XLA:CPU and ATen; the bounds of ``tests/test_engine_equivalence.py``;
  the reference's eager ops compile once per micro-batch shape, so 2 keep
  this file's time down), equal peak MFG sizes, and over 4 micro-batches
  within the same bounds of the port's whole-graph autograd oracle, with
  the neighbour explosion (peak input nodes > 0.5 |V|) showing.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.microbatch import build_full_mfg as jax_build_full_mfg
from repro.core.microbatch import microbatch_grads as jax_microbatch_grads
from repro.graph import NeighborSampler as JNeighborSampler
from repro.graph.csr import gcn_norm_coeffs
from repro.graph.synthetic import random_features, random_labels
from repro.models.gnn.layers import get_gnn as jax_get_gnn

from repro_torch.core.microbatch import build_full_mfg, microbatch_grads
from repro_torch.graph import NeighborSampler
from repro_torch.graph.csr import CSRGraph
from repro_torch.models.gnn.layers import (
    full_graph_loss, full_graph_topo, get_gnn,
)
from repro_torch.params import grads_to_jax, params_from_jax

FAMILIES = ["gcn", "sage", "gat", "gin", "pna", "graphcast"]
DIMS = (16, 24, 8)
N_MICRO = 4
N_MICRO_REF = 2
LOSS_TOL = 1e-4
GRAD_TOL = 1e-4


def port_graph(g):
    return CSRGraph(g.indptr.copy(), g.indices.copy(), g.n_nodes)


def assert_hops_equal(want, got):
    assert len(want) == len(got)
    for hw, hg in zip(want, got):
        assert hw.keys() == hg.keys()
        for k in hw:
            if isinstance(hw[k], np.ndarray):
                assert hw[k].dtype == hg[k].dtype, k
                assert np.array_equal(hw[k], hg[k]), k
            else:
                assert hw[k] == hg[k], k


@pytest.mark.parametrize("n_layers", [1, 2, 3])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("chunk", [0, 3])
def test_build_full_mfg_bitwise_reference(tiny_graph, n_layers, weighted,
                                          chunk):
    g = tiny_graph
    ew = gcn_norm_coeffs(g) if weighted else None
    seeds = np.array_split(np.arange(g.n_nodes, dtype=np.int64), 4)[chunk]
    hw, sw = jax_build_full_mfg(g, seeds, n_layers, ew)
    hg, sg = build_full_mfg(port_graph(g), seeds, n_layers, ew)
    assert np.array_equal(sw, sg) and sw.dtype == sg.dtype
    assert_hops_equal(hw, hg)


def test_build_full_mfg_bitwise_on_scattered_seeds(small_graph):
    g = small_graph
    seeds = np.random.default_rng(3).choice(g.n_nodes, 50, replace=False)
    hw, _ = jax_build_full_mfg(g, seeds, 2, gcn_norm_coeffs(g))
    hg, _ = build_full_mfg(port_graph(g), seeds, 2, gcn_norm_coeffs(g))
    assert_hops_equal(hw, hg)


@pytest.mark.parametrize("fanouts,seed", [([5], 1), ([10, 5], 0),
                                          ([4, 3, 2], 7)])
def test_neighbor_sampler_bitwise_reference(small_graph, fanouts, seed):
    g = small_graph
    sj = JNeighborSampler(g, fanouts, seed=seed)
    sp = NeighborSampler(port_graph(g), fanouts, seed=seed)
    for batch in (np.arange(64), np.arange(100, 132)):
        mw, mp = sj.sample(batch), sp.sample(batch)
        assert np.array_equal(mw.seeds, mp.seeds)
        assert mw.n_input_nodes == mp.n_input_nodes
        assert len(mw.layers) == len(mp.layers) == len(fanouts)
        for lw, lp in zip(mw.layers, mp.layers):
            assert lw.n_dst == lp.n_dst
            for k in ("node_ids", "src_index", "dst_index", "edge_mask"):
                a, b = getattr(lw, k), getattr(lp, k)
                assert a.dtype == b.dtype and np.array_equal(a, b), k


def jax_params(model, jspec):
    p = jspec.init(jax.random.PRNGKey(0), DIMS[0], DIMS[1], DIMS[2], 2)
    return [jax.tree_util.tree_map(np.asarray, layer) for layer in p]


def max_rel(want, got):
    errs = []
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        errs.append(np.max(np.abs(w - g)) / (np.max(np.abs(w)) + 1e-12))
    return max(errs)


@pytest.fixture(scope="module")
def data(tiny_graph):
    g = tiny_graph
    return (g, gcn_norm_coeffs(g), random_features(g.n_nodes, DIMS[0], 0),
            random_labels(g.n_nodes, DIMS[-1], 0))


@pytest.mark.parametrize("model", FAMILIES)
def test_microbatch_grads_match_reference(data, model):
    g, ew, X, Y = data
    jspec = jax_get_gnn(model)
    jp = jax_params(model, jspec)
    lw, gw, sw = jax_microbatch_grads(jspec, jp, g, X, Y, N_MICRO_REF,
                                      edge_weight=ew)
    params = params_from_jax(jp, device="cpu")
    lp, gp, sp = microbatch_grads(get_gnn(model), params, port_graph(g), X,
                                  Y, N_MICRO_REF, edge_weight=ew,
                                  device="cpu")
    assert abs(lp - lw) <= LOSS_TOL * max(1.0, abs(lw)), (lp, lw)
    assert max_rel(gw, grads_to_jax(gp)) <= GRAD_TOL
    assert sp["peak_input_nodes"] == sw["peak_input_nodes"]
    assert sp["peak_mfg_edges"] == sw["peak_mfg_edges"]
    assert len(sp["hop_edges"]) == N_MICRO_REF
    assert max(sum(e) for e in sp["hop_edges"]) == sp["peak_mfg_edges"]


@pytest.mark.parametrize("model", FAMILIES)
def test_microbatch_grads_match_full_graph_oracle(data, model):
    g, ew, X, Y = data
    spec = get_gnn(model)
    jp = jax_params(model, jax_get_gnn(model))
    params = params_from_jax(jp, device="cpu")
    topo = full_graph_topo(g.indptr, g.indices, g.n_nodes, ew, device="cpu")
    loss = full_graph_loss(spec, params, X, topo, Y)
    names = [n for layer in params for n, _ in layer.named_parameters()]
    want = torch.autograd.grad(loss, list(params.parameters()))
    lp, gp, sp = microbatch_grads(spec, params, port_graph(g), X, Y, N_MICRO,
                                  edge_weight=ew, device="cpu")
    got = [t for layer in gp for t in layer.values()]
    assert [n for layer in gp for n in layer] == names
    assert abs(lp - float(loss.detach())) <= LOSS_TOL
    for w, t in zip(want, got):
        err = float((w - t).abs().max() / (w.abs().max() + 1e-12))
        assert err <= GRAD_TOL
    assert sp["peak_input_nodes"] > 0.5 * g.n_nodes   # neighbour explosion
