"""The port's ``embedding_bag`` (the wrapper on CPU tensors, which runs the
plain version; the ``EmbeddingBag`` backward; the model's general
``embedding_bag``) against the reference: the JAX Pallas kernel in
interpret mode, its ``embedding_bag_ref`` oracle and the two-tower model's
``embedding_bag``, on the same numpy inputs.

Tolerance: 1e-6 relative to each result's largest magnitude — both sides
add the same float32 rows, in the same order where the order is defined
(the kernel and the oracle sum each bag in ``k`` order). The backward is
also held bitwise against ``np.add.at`` in input order. The CUDA kernel
itself is tested on the card (``tests/test_torch_cuda_kernels.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import (
    embedding_bag_kernel_call, embedding_bag_ref as jax_ref,
)
from repro.models.recsys.two_tower import embedding_bag as jax_model_bag

from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.embedding_bag import (
    LAUNCHES, EmbeddingBag, embedding_bag, embedding_bag_backward_ref,
    embedding_bag_ref,
)
from repro_torch.models.recsys import two_tower as tt

RTOL = 1e-6


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.nanmax(np.abs(want))) if want.size else 0.0, 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _inputs(V, D, n_bags, bag, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, (n_bags, bag)).astype(np.int32)
    if bag > 1:
        ids[: n_bags // 2 + 1, 1] = ids[: n_bags // 2 + 1, 0]  # duplicates
    return table, ids


def _jax_model(table, ids, mode):
    n_bags, bag = ids.shape
    seg = np.repeat(np.arange(n_bags), bag).astype(np.int32)
    return np.asarray(jax_model_bag(
        jnp.asarray(table), jnp.asarray(ids.reshape(-1)), jnp.asarray(seg),
        n_bags, mode=mode))


# interpret mode runs the Pallas grid (n_bags, D / 128, bag) step by step:
# keep these grids tiny
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("V,D,n_bags,bag", [
    (50, 7, 16, 6), (40, 16, 5, 3), (30, 256, 3, 2),
])
def test_embedding_bag_matches_pallas_interpret(V, D, n_bags, bag, mode):
    table, ids = _inputs(V, D, n_bags, bag, seed=V + D)
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), mode)
    want = embedding_bag_kernel_call(jnp.asarray(table), jnp.asarray(ids),
                                     mode=mode, interpret=True)
    assert got.shape == (n_bags, D) and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("V,D,n_bags,bag", [
    (100, 7, 16, 6), (64, 16, 1, 1), (300, 16, 9, 4), (500, 256, 12, 5),
    (20, 256, 16, 1),
])
def test_embedding_bag_matches_oracle_and_model(V, D, n_bags, bag, mode):
    table, ids = _inputs(V, D, n_bags, bag, seed=3 * V + D)
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                        mode).numpy()
    _close(got, np.asarray(jax_ref(jnp.asarray(table), jnp.asarray(ids),
                                   mode=mode)))
    _close(got, _jax_model(table, ids, mode))
    # the plain version is what the wrapper ran: the same bits
    np.testing.assert_array_equal(
        got, embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(ids),
                               mode).numpy())


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_wraps_and_nans_like_jnp_take(mode):
    """``jnp.take`` (the model's lookup): ids in [-V, 0) wrap, any other id
    outside [0, V) makes its bag NaN; the other bags are unaffected."""
    V, D = 12, 5
    rng = np.random.default_rng(4)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = np.array([[1, -1, 3], [V, 0, 2], [-V, 4, 4], [-V - 1, 5, 6],
                    [7, 8, 9], [2, -5, 11]], np.int32)
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                        mode).numpy()
    want = _jax_model(table, ids, mode)
    nan_rows = np.isnan(got).all(axis=1)
    np.testing.assert_array_equal(nan_rows, [False, True, False, True,
                                             False, False])
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
    _close(got, want)
    wrapped = np.where(ids < 0, ids + V, ids)
    _close(got[0], table[wrapped[0]].sum(0) / (3.0 if mode == "mean" else 1.0))


def test_embedding_bag_degenerate_shapes_and_bad_args():
    table = torch.randn(10, 4)
    assert embedding_bag(table, torch.zeros((0, 3), dtype=torch.int32)).shape \
        == (0, 4)
    out = embedding_bag(table, torch.zeros((5, 0), dtype=torch.int32), "mean")
    assert out.shape == (5, 4) and not out.any()
    with pytest.raises(ValueError, match="mode"):
        embedding_bag(table, torch.zeros((2, 2), dtype=torch.int32), "max")
    with pytest.raises(ValueError, match="n_bags, bag_size"):
        embedding_bag(table, torch.zeros(4, dtype=torch.int32))


def _np_grad(d_out, ids, V, mode):
    """Oracle: ``np.add.at`` of each lookup's output gradient into its
    row, in input order; ids that name no row add nothing."""
    n_bags, bag = ids.shape
    flat = ids.reshape(-1).astype(np.int64)
    flat = np.where(flat < 0, flat + V, flat)
    valid = (flat >= 0) & (flat < V)
    vals = d_out[np.arange(flat.size) // bag]
    if mode == "mean":
        vals = vals / np.float32(bag)
    grad = np.zeros((V, d_out.shape[1]), np.float32)
    np.add.at(grad, flat[valid], vals[valid])
    return grad


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("V,D,n_bags,bag", [(40, 7, 16, 6), (300, 16, 9, 3),
                                            (64, 256, 4, 5)])
def test_embedding_bag_backward_matches_jax_vjp_and_np_add_at(V, D, n_bags,
                                                             bag, mode):
    table, ids = _inputs(V, D, n_bags, bag, seed=V * D + bag)
    ids[0, 0] = -2                    # wraps to V - 2
    ids[-1, -1] = ids[-2, -1] = 3     # one row shared across bags
    rng = np.random.default_rng(9)
    d_out = rng.standard_normal((n_bags, D)).astype(np.float32)
    t = torch.from_numpy(table).requires_grad_(True)
    out = EmbeddingBag.apply(t, torch.from_numpy(ids), mode, "kernel")
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(d_out))
    got = got.numpy()
    np.testing.assert_array_equal(got, _np_grad(d_out, ids, V, mode))

    seg = jnp.asarray(np.repeat(np.arange(n_bags), bag).astype(np.int32))
    _, vjp = jax.vjp(
        lambda tb: jax_model_bag(tb, jnp.asarray(ids.reshape(-1)), seg,
                                 n_bags, mode=mode), jnp.asarray(table))
    _close(got, np.asarray(vjp(jnp.asarray(d_out))[0]))


def test_embedding_bag_backward_drops_invalid_ids():
    V, D = 8, 3
    ids = np.array([[1, V], [-V - 2, 1], [2, 2]], np.int32)
    d_out = np.arange(9, dtype=np.float32).reshape(3, 3) + 1
    got = embedding_bag_backward_ref(torch.from_numpy(d_out),
                                     torch.from_numpy(ids), V, "sum").numpy()
    np.testing.assert_array_equal(got, _np_grad(d_out, ids, V, "sum"))
    assert not got[0].any() and got[1].any() and got[2].any()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_function_kernel_and_reference_routes_agree(mode):
    """On CPU tensors both routes run the plain versions: the same bits,
    and no kernel launch is counted."""
    table, ids = _inputs(60, 16, 10, 4, seed=11)
    reset_launches()
    res = {}
    for kernels in ("kernel", "reference"):
        t = torch.from_numpy(table).requires_grad_(True)
        out = EmbeddingBag.apply(t, torch.from_numpy(ids), mode, kernels)
        out.square().sum().backward()
        res[kernels] = (out.detach(), t.grad)
    assert all(torch.equal(a, b) for a, b in zip(res["kernel"],
                                                 res["reference"]))
    assert LAUNCHES["embedding_bag"] == 0
    assert not any(launch_counts().values())
    with pytest.raises(ValueError, match="kernels"):
        EmbeddingBag.apply(torch.from_numpy(table), torch.from_numpy(ids),
                           mode, "auto")


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_model_embedding_bag_matches_jax_model(mode, weighted):
    """The model's general ``embedding_bag``: unsorted, uneven bags, an
    empty bag, optional per-lookup weights; forward and table gradient."""
    V, D, n_bags, N = 50, 6, 7, 40
    rng = np.random.default_rng(5)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(-V, V, N).astype(np.int32)
    bag_ids = rng.integers(0, n_bags - 1, N).astype(np.int32)   # last empty
    w = rng.standard_normal(N).astype(np.float32) if weighted else None
    t = torch.from_numpy(table).requires_grad_(True)
    got = tt.embedding_bag(t, torch.from_numpy(ids), torch.from_numpy(bag_ids),
                           n_bags, mode,
                           None if w is None else torch.from_numpy(w))
    d_out = rng.standard_normal((n_bags, D)).astype(np.float32)
    (g,) = torch.autograd.grad(got, t, torch.from_numpy(d_out))
    want, vjp = jax.vjp(
        lambda tb: jax_model_bag(tb, jnp.asarray(ids), jnp.asarray(bag_ids),
                                 n_bags, mode,
                                 None if w is None else jnp.asarray(w)),
        jnp.asarray(table))
    _close(got.detach().numpy(), np.asarray(want))
    assert not got[-1].any()
    _close(g.numpy(), np.asarray(vjp(jnp.asarray(d_out))[0]))
