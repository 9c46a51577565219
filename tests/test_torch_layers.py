"""Port GCN layers vs the reference JAX layers, with the same weights
(converted by ``params_from_jax``) and the same numpy inputs.

Tolerance: max relative error ``max|a-b| / max|a|`` <= 1e-5 — float32
reassociation between XLA:CPU and ATen in the matmul and the segment sum.
Inside the port, the segment sum is deterministic (bitwise on a rerun)."""
import jax
import numpy as np
import pytest
import torch

from repro.models.gnn import layers as jl

from repro_torch.models.gnn import layers as tl
from repro_torch.params import params_from_jax


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30)


def _topos(rng, n_src, n_dst, E, pad=0):
    src = rng.integers(0, n_src, E).astype(np.int32)
    dst = np.sort(rng.integers(0, n_dst, E)).astype(np.int32)
    ew = rng.random(E).astype(np.float32)
    mask = np.ones(E, np.float32)
    if pad:
        src = np.concatenate([src, np.zeros(pad, np.int32)])
        dst = np.concatenate([dst, np.zeros(pad, np.int32)])
        ew = np.concatenate([ew, np.zeros(pad, np.float32)])
        mask = np.concatenate([mask, np.zeros(pad, np.float32)])
    deg = np.maximum(np.bincount(dst[: E], minlength=n_dst), 1)
    deg = deg.astype(np.float32)
    self_ = rng.integers(0, n_src, n_dst).astype(np.int32)
    j = jl.LocalTopo(*(jax.numpy.asarray(a) for a in (src, dst)), n_dst,
                     *(jax.numpy.asarray(a) for a in (ew, mask, deg, self_)))
    t = tl.LocalTopo(*(torch.from_numpy(a) for a in (src, dst)), n_dst,
                     *(torch.from_numpy(a) for a in (ew, mask, deg, self_)),
                     n_real_edges=E)
    return j, t


@pytest.mark.parametrize("activate", [True, False])
@pytest.mark.parametrize("n_src,n_dst,E,d_in,d_out,pad", [
    (64, 32, 300, 16, 8, 0), (128, 50, 900, 24, 32, 124), (7, 3, 1, 5, 3, 7),
])
def test_gcn_apply_matches_reference(n_src, n_dst, E, d_in, d_out, pad,
                                     activate):
    rng = np.random.default_rng(E)
    jtopo, ttopo = _topos(rng, n_src, n_dst, E, pad)
    jp = jl.gcn_init(jax.random.PRNGKey(E), d_in, d_out)
    jp = {"lin": {"w": np.asarray(jp["lin"]["w"]),
                  "b": rng.standard_normal(d_out).astype(np.float32)}}
    layer = params_from_jax([jp], device="cpu")[0]
    ga = rng.standard_normal((n_src, d_in)).astype(np.float32)
    want = np.asarray(jl.gcn_apply(jp, ga, jtopo, activate=activate))
    with torch.no_grad():
        got = tl.gcn_apply(layer, torch.from_numpy(ga), ttopo,
                           activate=activate).numpy()
    assert got.shape == want.shape == (n_dst, d_out)
    assert _rel(want, got) <= 1e-5


def test_full_graph_forward_matches_reference(tiny_graph):
    g = tiny_graph
    from repro.graph.csr import gcn_norm_coeffs

    ew = gcn_norm_coeffs(g)
    dims = [12, 16, 16, 5]
    spec = jl.get_gnn("gcn")
    jp = spec.init(jax.random.PRNGKey(1), dims[0], dims[1], dims[-1], 3)
    x = np.random.default_rng(1).standard_normal(
        (g.n_nodes, dims[0])).astype(np.float32)
    jt = jl.full_graph_topo(g.indptr, g.indices, g.n_nodes, ew)
    want = np.asarray(jl.full_graph_forward(spec, jp, x, jt))
    params = params_from_jax(
        [jax.tree_util.tree_map(np.asarray, p) for p in jp], device="cpu")
    tt = tl.full_graph_topo(g.indptr, g.indices, g.n_nodes, ew, device="cpu")
    for f in ("src", "dst", "edge_weight", "edge_mask", "in_deg", "dst_self"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)))
    with torch.no_grad():
        got = tl.full_graph_forward(tl.get_gnn("gcn"), params, x, tt).numpy()
    assert _rel(want, got) <= 1e-5


def test_seg_sum_is_deterministic_and_sequential():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5000, 40)).astype(np.float32)
    seg = np.sort(rng.integers(0, 300, 5000)).astype(np.int32)
    a = tl.seg_sum(torch.from_numpy(x), torch.from_numpy(seg), 301)
    b = tl.seg_sum(torch.from_numpy(x), torch.from_numpy(seg), 301)
    assert torch.equal(a, b)
    want = np.zeros((301, 40), np.float32)
    np.add.at(want, seg, x)          # sequential, in edge order
    np.testing.assert_array_equal(a.numpy(), want)


def test_params_from_jax_layout_and_validation():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    (layer,) = params_from_jax([{"lin": {"w": w, "b": b}}], device="cpu")
    np.testing.assert_array_equal(layer.lin.weight.detach().numpy(), w.T)
    np.testing.assert_array_equal(layer.lin.bias.detach().numpy(), b)
    with pytest.raises(ValueError, match="only GCN"):
        params_from_jax([{"self": {}, "nbr": {}}], device="cpu")
    with pytest.raises(ValueError, match="dense layer"):
        params_from_jax([{"lin": {"w": w, "b": b[:3]}}], device="cpu")


def test_spec_init_is_seeded_and_shaped():
    spec = tl.get_gnn("gcn")
    a = spec.init(torch.Generator().manual_seed(5), 10, 16, 3, 3, device="cpu")
    b = spec.init(torch.Generator().manual_seed(5), 10, 16, 3, 3, device="cpu")
    assert [tuple(l.lin.weight.shape) for l in a] == [(16, 10), (16, 16),
                                                       (3, 16)]
    for la, lb in zip(a, b):
        assert torch.equal(la.lin.weight, lb.lin.weight)
        assert torch.count_nonzero(la.lin.bias) == 0
    # N(0, 1/d_in) like the reference init
    big = spec.init(torch.Generator().manual_seed(0), 400, 400, 400, 1,
                    device="cpu")[0].lin.weight.detach()
    assert abs(float(big.std()) * np.sqrt(400) - 1.0) < 0.02
    with pytest.raises(KeyError, match="not ported"):
        tl.get_gnn("gat")


def test_local_topo_to_moves_every_tensor():
    rng = np.random.default_rng(0)
    _, t = _topos(rng, 10, 4, 20, pad=4)
    m = t.to("meta")
    assert m.device.type == "meta" and m.n_dst == t.n_dst
    assert all(getattr(m, f).device.type == "meta"
               for f in ("src", "dst", "edge_weight", "edge_mask", "in_deg",
                         "dst_self"))
