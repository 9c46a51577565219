"""The port's six GNN families vs the reference JAX layers, with the same
weights (converted by ``repro_torch.params``) and the same numpy inputs.

Tolerances, as max relative error ``max|a-b| / max|a|``:

- forward ``apply_layer``: 1e-5 — float32 reassociation between XLA:CPU and
  ATen in the matmuls, the segment sums and the layer norms;
- vjp (every parameter gradient and ``dL/dga``): 1e-4 — the same
  reassociation, carried through a backward that sums the cotangents of
  two or three gathers of one row in another order, and (GAT, PNA) through
  the max's recomputed tie split.

``seg_max`` is held to ``jax.ops.segment_max`` bitwise in the forward and
within one rounding in its vjp's tie split (``g / count`` here, ``g`` times
the reciprocal count in JAX); ``_layernorm`` to the reference's manual form.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.gnn import layers as jl

from repro_torch.models.gnn import layers as tl
from repro_torch.params import (
    LAYOUT, grads_to_jax, params_from_jax, params_to_numpy,
)

FAMILIES = ["gcn", "sage", "gat", "gin", "pna", "graphcast"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30)


def _topos(rng, n_src, n_dst, E, pad=0, empty_rows=0):
    """Sorted real edges into ``n_dst - empty_rows`` rows (the last
    ``empty_rows`` rows have none, as a plan's padded rows), then ``pad``
    padding edges at slot 0 with mask 0, as the plan lays them out."""
    src = rng.integers(0, n_src, E).astype(np.int32)
    dst = np.sort(rng.integers(0, n_dst - empty_rows, E)).astype(np.int32)
    ew = rng.random(E).astype(np.float32)
    mask = np.ones(E, np.float32)
    z = lambda dt: np.zeros(pad, dt)
    src, dst = np.concatenate([src, z(np.int32)]), np.concatenate(
        [dst, z(np.int32)])
    ew, mask = np.concatenate([ew, z(np.float32)]), np.concatenate(
        [mask, z(np.float32)])
    deg = np.maximum(np.bincount(dst[:E], minlength=n_dst), 1)
    deg = deg.astype(np.float32)
    self_ = rng.integers(0, n_src, n_dst).astype(np.int32)
    j = jl.LocalTopo(*(jnp.asarray(a) for a in (src, dst)), n_dst,
                     *(jnp.asarray(a) for a in (ew, mask, deg, self_)))
    t = tl.LocalTopo(*(torch.from_numpy(a) for a in (src, dst)), n_dst,
                     *(torch.from_numpy(a) for a in (ew, mask, deg, self_)),
                     n_real_edges=E)
    return j, t


def _jax_params(model, d_in, d_out, seed):
    """Reference init, every leaf moved off its init value (zero biases,
    ``eps = 0`` and ``log_mean_deg = 1`` would hide a dropped term)."""
    rng = np.random.default_rng(seed)
    p = jl.get_gnn(model).init_layer(jax.random.PRNGKey(seed), d_in, d_out)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), p)


# (n_src, n_dst, E, d_in, d_out, padding edges, rows without edges)
SHAPES = [(64, 32, 300, 16, 8, 0, 0), (128, 50, 900, 24, 32, 124, 5),
          (7, 3, 1, 5, 3, 7, 1)]


@pytest.mark.parametrize("shape,activate", [
    (SHAPES[0], True), (SHAPES[1], True), (SHAPES[1], False),
    (SHAPES[2], False),
])
@pytest.mark.parametrize("model", FAMILIES)
def test_apply_layer_and_vjp_match_reference(model, shape, activate):
    n_src, n_dst, E, d_in, d_out, pad, empty = shape
    rng = np.random.default_rng(E + d_out)
    jtopo, ttopo = _topos(rng, n_src, n_dst, E, pad, empty)
    jp = _jax_params(model, d_in, d_out, E)
    (layer,) = params_from_jax([jp], device="cpu")
    ga = rng.standard_normal((n_src, d_in)).astype(np.float32)
    japply = jl.get_gnn(model).apply_layer
    want, vjp = jax.vjp(
        lambda p, x: japply(p, x, jtopo, activate=activate), jp,
        jnp.asarray(ga))
    want = np.asarray(want)
    spec = tl.get_gnn(model)
    with torch.no_grad():
        got = spec.apply_layer(layer, torch.from_numpy(ga), ttopo,
                               activate=activate).numpy()
    assert got.shape == want.shape == (n_dst, d_out)
    assert np.all(np.isfinite(got))
    assert _rel(want, got) <= 1e-5

    d_out_ct = rng.standard_normal(want.shape).astype(np.float32)
    jdp, jdga = vjp(jnp.asarray(d_out_ct))
    dp, dga = tl.apply_vjp(spec.apply_layer, layer, torch.from_numpy(ga),
                           ttopo, torch.from_numpy(d_out_ct), activate)
    (tdp,) = grads_to_jax([dp], model=model)
    leaves_w = jax.tree_util.tree_leaves(jdp)
    leaves_g = jax.tree_util.tree_leaves(tdp)
    assert len(leaves_w) == len(leaves_g)
    for w, g in zip(leaves_w, leaves_g):
        assert np.shape(w) == np.shape(g)
        assert _rel(w, g) <= 1e-4
    assert _rel(jdga, dga.numpy()) <= 1e-4


@pytest.mark.parametrize("model", FAMILIES)
def test_param_converters_round_trip(model):
    jp = [_jax_params(model, 12, 16, 1), _jax_params(model, 16, 6, 2)]
    params = params_from_jax(jp, device="cpu")
    assert isinstance(params[0], tl.get_gnn(model).layer_cls)
    back = params_to_numpy(params)
    for want, got in zip(jp, back):
        assert sorted(want) == sorted(got)
        for w, g in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(np.asarray(w), g)
    # gradients come back in the same layout (named like the parameters)
    grads = [{k: v.detach() * 2 for k, v in layer.named_parameters()}
             for layer in params]
    for want, got in zip(jp, grads_to_jax(grads)):
        for w, g in zip(jax.tree_util.tree_leaves(want),
                        jax.tree_util.tree_leaves(got)):
            np.testing.assert_array_equal(np.asarray(w) * 2, g)
    assert params_to_numpy(params, model=model)[0].keys() == jp[0].keys()


def test_param_converters_validate():
    jp = _jax_params("sage", 6, 4, 0)
    (layer,) = params_from_jax([jp], device="cpu")
    assert {n for n, _ in layer.named_parameters()} == {
        "lin_self.weight", "lin_self.bias", "nbr.weight", "nbr.bias"}
    with pytest.raises(ValueError, match="match no GNN family"):
        params_from_jax([{"self": jp["self"]}], device="cpu")
    with pytest.raises(ValueError, match="gcn params have keys"):
        params_from_jax([jp], device="cpu", model="gcn")
    with pytest.raises(ValueError, match="unknown GNN family"):
        grads_to_jax([{}], model="gcnx")
    bad = dict(jp, nbr={"w": jp["nbr"]["w"], "b": jp["nbr"]["b"][:2]})
    with pytest.raises(ValueError, match="dense layer"):
        params_from_jax([bad], device="cpu")
    gat = _jax_params("gat", 6, 8, 0)
    with pytest.raises(ValueError, match="does not fit"):
        params_from_jax([dict(gat, b=gat["b"][:3])], device="cpu")
    # every family the reference has converts; gcnii, the port's own
    # family, has no reference counterpart and so no converter
    assert set(LAYOUT) == set(jl.GNN_REGISTRY) \
        == set(tl.GNN_REGISTRY) - {"gcnii"}


@pytest.mark.parametrize("model", FAMILIES)
def test_spec_init_is_seeded_and_matches_reference_shapes(model):
    spec = tl.get_gnn(model)
    a = spec.init(torch.Generator().manual_seed(3), 10, 16, 6, 3,
                  device="cpu")
    b = spec.init(torch.Generator().manual_seed(3), 10, 16, 6, 3,
                  device="cpu")
    jp = jl.get_gnn(model).init(jax.random.PRNGKey(0), 10, 16, 6, 3)
    for la, lb, j in zip(a, b, jp):
        for (n, x), y in zip(la.named_parameters(), lb.parameters()):
            assert torch.equal(x, y), n
        got = params_to_numpy([la])[0]
        for w, g in zip(jax.tree_util.tree_leaves(j),
                        jax.tree_util.tree_leaves(got)):
            assert np.shape(w) == np.shape(g)
            if not np.any(np.asarray(w)):          # zero-initialised leaves
                assert not np.any(g)
    if model == "gat":   # 4 heads, 1 where d_out % 4 != 0 (as gat_init)
        assert tuple(a[0].w.shape) == (10, 4, 4)
        assert tuple(a[2].w.shape) == (16, 1, 6)
    if model == "pna":
        assert a[0].log_mean_deg.item() == 1.0


def test_seg_max_matches_jax_forward_and_tie_split():
    rng = np.random.default_rng(0)
    # ties (repeated values, +0/-0 as PNA's negated relu gives) and an
    # empty segment
    x = rng.integers(-3, 3, (400, 5)).astype(np.float32)
    x[::7] = -0.0
    x[::11] = 0.0
    seg = np.sort(rng.integers(0, 60, 400)).astype(np.int32)
    seg[seg == 17] = 18
    n = 62
    g = rng.standard_normal((n, 5)).astype(np.float32)
    want, vjp = jax.vjp(
        lambda a: jax.ops.segment_max(a, jnp.asarray(seg), num_segments=n),
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tl.seg_max(xt, torch.from_numpy(seg), n)
    # values equal (a tie of +0 and -0 may keep either zero)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    assert np.all(np.isneginf(got.detach().numpy()[[17, 60, 61]]))
    (dx,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    # the same tied elements get the same share: g / count here, g times
    # the reciprocal count in JAX (one rounding apart)
    jdx = np.asarray(vjp(g)[0])
    np.testing.assert_array_equal(dx.numpy() != 0, jdx != 0)
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=2.0 ** -23, atol=0)
    again = tl.seg_max(torch.from_numpy(x), torch.from_numpy(seg), n)
    assert torch.equal(again, got.detach())
    # -0 and +0 tie: the split counts both
    z = torch.tensor([[-0.0], [0.0], [-1.0]], requires_grad=True)
    m = tl.seg_max(z, torch.tensor([0, 0, 0], dtype=torch.int32), 1)
    (dz,) = torch.autograd.grad(m, z, torch.ones(1, 1))
    assert dz[:, 0].tolist() == [0.5, 0.5, 0.0]
    assert tl.seg_max(torch.zeros(0, 3), torch.zeros(0, dtype=torch.int32),
                      2).isneginf().all()


def test_layernorm_matches_reference():
    x = np.random.default_rng(1).standard_normal((50, 33)).astype(np.float32)
    want = np.asarray(jl._layernorm(jnp.asarray(x)))
    got = tl._layernorm(torch.from_numpy(x)).numpy()
    assert _rel(want, got) <= 1e-6


@pytest.mark.parametrize("model", FAMILIES)
def test_kink_probe_records_and_forces_branches(model):
    """Under ``kink_probe`` each family's layer gives the plain run's output
    and gradients bitwise and records one sign mask per ``relu`` /
    ``leaky_relu``; forcing the recorded signs changes nothing, and forcing
    one element onto the other branch moves the gradients."""
    rng = np.random.default_rng(11)
    _, tt = _topos(rng, 64, 32, 300)
    spec = tl.get_gnn(model)
    (layer,) = params_from_jax([_jax_params(model, 16, 8, 4)], device="cpu",
                               model=model)
    ga = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))

    def run(force=None):
        with tl.kink_probe(force) as probe:
            dp, dga = tl.apply_vjp(spec.apply_layer, layer, ga, tt, ct, True)
            with torch.no_grad():
                out = spec.apply_layer(layer, ga, tt, activate=True)
        return [out, dga, *dp.values()], probe.signs

    dp, dga = tl.apply_vjp(spec.apply_layer, layer, ga, tt, ct, True)
    with torch.no_grad():
        plain = [spec.apply_layer(layer, ga, tt, activate=True), dga,
                 *dp.values()]
    got, signs = run()
    assert all(torch.equal(a, b) for a, b in zip(plain, got))
    n_kinks = {"gcn": 1, "sage": 1, "gat": 1, "gin": 2, "pna": 2,
               "graphcast": 1}[model]
    assert len(signs) == 2 * n_kinks          # the vjp's forward, then ours
    forced, _ = run(force=signs)
    assert all(torch.equal(a, b) for a, b in zip(plain, forced))
    flip = [s.clone() for s in signs]
    # the output kink of the vjp's own forward (recorded first)
    i = n_kinks - 1
    pos = flip[i].flatten().nonzero()[0]
    flip[i].view(-1)[pos] = False
    moved, _ = run(force=flip)
    assert not all(torch.equal(a, b) for a, b in zip(plain[1:], moved[1:]))
