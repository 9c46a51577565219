"""The port's ``edge_softmax`` (wrapper on CPU tensors, which runs the plain
version; the ``EdgeSoftmax`` backward; the dispatcher's GAT route) against
the reference: the JAX ``edge_softmax`` Pallas kernel in interpret mode and
its ``edge_softmax_ref`` oracle, on the same numpy inputs.

Tolerance rtol 1e-5 / atol 1e-6, forward and backward: float32 exp and
segment sums in another order (XLA:CPU vs ATen); the JAX vjp also carries
the segment max's path, which cancels only up to rounding. The CUDA kernel
itself is tested on the card (``tests/test_torch_cuda_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.edge_softmax import (
    edge_softmax as jax_edge_softmax, edge_softmax_ref as jax_ref,
    pack_edges_by_block,
)
from repro.models.gnn import layers as jl

from repro_torch.core.counters import Counters
from repro_torch.kernels.dispatch import KernelDispatch
from repro_torch.kernels.edge_softmax import (
    LAUNCHES, EdgeSoftmax, edge_softmax, edge_softmax_np,
)
from repro_torch.models.gnn import layers as tl
from repro_torch.params import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(rng, n, E, H):
    dst = np.sort(rng.integers(0, n, E)).astype(np.int32)
    scores = rng.standard_normal((E, H)).astype(np.float32)
    return scores, dst


@pytest.mark.parametrize("n,E,H", [(200, 1500, 1), (300, 2500, 4),
                                   (128, 600, 8)])
def test_matches_jax_kernel_and_ref(n, E, H, rng):
    scores, dst = _inputs(rng, n, E, H)
    perm, dst_local, mask, _ = pack_edges_by_block(dst, n)
    kern = np.asarray(jax_edge_softmax(
        jnp.asarray(scores), jnp.asarray(perm), jnp.asarray(dst_local),
        jnp.asarray(mask), interpret=True))
    want = np.asarray(jax_ref(jnp.asarray(scores), jnp.asarray(dst), n))
    before = LAUNCHES["edge_softmax"]
    got = edge_softmax(torch.from_numpy(scores), torch.from_numpy(dst), n)
    assert LAUNCHES["edge_softmax"] == before      # plain version on CPU
    assert got.shape == (E, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), kern, **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), edge_softmax_np(scores, dst, n),
                               **TOL)
    again = edge_softmax(torch.from_numpy(scores), torch.from_numpy(dst), n)
    assert torch.equal(again, got)


def test_rows_without_edges_and_rows_sum_to_one(rng):
    """Destination rows with no edge (the first rows, a gap, the padded
    tail of a plan's rows) take no part; every row with edges sums to 1."""
    n, E, H = 90, 700, 3
    dst = np.sort(rng.integers(5, 60, E)).astype(np.int32)
    dst[dst == 30] = 31
    scores = (rng.standard_normal((E, H)) * 20).astype(np.float32)
    got = edge_softmax(torch.from_numpy(scores), torch.from_numpy(dst), n)
    want = np.asarray(jax_ref(jnp.asarray(scores), jnp.asarray(dst), n))
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    sums = np.zeros((n, H))
    np.add.at(sums, dst, got.numpy().astype(np.float64))
    touched = np.bincount(dst, minlength=n) > 0
    assert not touched[:5].any() and not touched[30] and not touched[60:].any()
    np.testing.assert_allclose(sums[touched], 1.0, rtol=1e-5)
    assert not sums[~touched].any()


@pytest.mark.parametrize("n,E,H", [(200, 1500, 1), (300, 2500, 4)])
def test_backward_matches_jax_vjp(n, E, H, rng):
    scores, dst = _inputs(rng, n, E, H)
    d_attn = rng.standard_normal((E, H)).astype(np.float32)
    _, vjp = jax.vjp(lambda s: jax_ref(s, jnp.asarray(dst), n),
                     jnp.asarray(scores))
    (want,) = vjp(jnp.asarray(d_attn))
    s = torch.from_numpy(scores).requires_grad_(True)
    attn = EdgeSoftmax.apply(s, torch.from_numpy(dst), n)
    (got,) = torch.autograd.grad(attn, s, torch.from_numpy(d_attn))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_checks_and_degenerate_inputs():
    s = torch.zeros(5, 2)
    d = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match=r"scores \(E, H\)"):
        edge_softmax(torch.zeros(5), d, 3)
    with pytest.raises(ValueError, match="edges, dst"):
        edge_softmax(s, d[:4], 3)
    with pytest.raises(ValueError, match="n_dst=0"):
        edge_softmax(s, d, 0)
    out = edge_softmax(torch.zeros(0, 4), torch.zeros(0, dtype=torch.int32), 0)
    assert out.shape == (0, 4)


def _topo(rng, n_src, n_dst, E, pad):
    src = rng.integers(0, n_src, E).astype(np.int32)
    dst = np.sort(rng.integers(0, n_dst - 2, E)).astype(np.int32)
    mask = np.concatenate([np.ones(E, np.float32), np.zeros(pad, np.float32)])
    src = np.concatenate([src, np.zeros(pad, np.int32)])
    dst = np.concatenate([dst, np.zeros(pad, np.int32)])
    deg = np.maximum(np.bincount(dst[:E], minlength=n_dst), 1).astype(
        np.float32)
    self_ = rng.integers(0, n_src, n_dst).astype(np.int32)
    j = jl.LocalTopo(jnp.asarray(src), jnp.asarray(dst), n_dst,
                     jnp.asarray(mask), jnp.asarray(mask), jnp.asarray(deg),
                     jnp.asarray(self_))
    t = tl.LocalTopo(*(torch.from_numpy(a) for a in (src, dst)), n_dst,
                     *(torch.from_numpy(a) for a in (mask, mask, deg, self_)),
                     n_real_edges=E)
    return j, t


@pytest.mark.parametrize("activate", [True, False])
def test_gat_with_dispatched_softmax_matches_reference(activate, rng):
    """The dispatcher's ``kernel-fused`` GAT softmax (real-edge prefix to
    the kernel wrapper, padding 0) inside ``gat_apply`` and its vjp, against
    the JAX layer; the span lands under ``kernel:edge_softmax.ref``."""
    jt, tt = _topo(rng, 80, 40, 500, 36)
    jp = jl.gat_init(jax.random.PRNGKey(3), 16, 12)
    jp = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.standard_normal(np.shape(a))
                   ).astype(np.float32), jp)
    (layer,) = params_from_jax([jp], device="cpu")
    c = Counters()
    kd = KernelDispatch("kernel-fused", c, device="cpu")
    apply = kd._apply_fn(tl.get_gnn("gat"))
    ga = rng.standard_normal((80, 16)).astype(np.float32)
    want, vjp = jax.vjp(lambda p, x: jl.gat_apply(p, x, jt, activate), jp,
                        jnp.asarray(ga))
    with torch.no_grad():
        got = apply(layer, torch.from_numpy(ga), tt, activate=activate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ct = rng.standard_normal(np.shape(want)).astype(np.float32)
    jdp, jdga = vjp(jnp.asarray(ct))
    dp, dga = tl.apply_vjp(apply, layer, torch.from_numpy(ga), tt,
                           torch.from_numpy(ct), activate)
    np.testing.assert_allclose(dga.numpy(), np.asarray(jdga), rtol=1e-4,
                               atol=1e-5)
    for k in ("w", "a_src", "a_dst", "b"):
        np.testing.assert_allclose(dp[k].numpy(), np.asarray(jdp[k]),
                                   rtol=1e-4, atol=1e-5)
    assert c.phase_seconds.get("kernel:edge_softmax.ref", 0.0) > 0.0
