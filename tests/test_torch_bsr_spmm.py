"""The port's block-sparse SpMM (``blockify_edges``, ``bsr_spmm`` and
``bsr_spmm_kernel`` on CPU tensors, which run the plain version) against
the reference: the JAX ``bsr_spmm`` Pallas kernel in interpret mode, its
``bsr_spmm_ref`` / ``spmm_edges_ref`` oracles, on the same numpy inputs.

Tolerances: float32 rtol = atol = 2e-5, the reference's own float32
kernel-test tolerance (``tests/test_kernels.py`` ``_tol``): the block
products and the sums across a row's blocks run in another order than
XLA:CPU's. bfloat16 x within 5e-2 of the float32 edge-list oracle and of
the JAX bf16 kernel, the reference's bf16 tolerance
(``tests/test_kernels.py`` ``test_bf16``). ``blockify_edges`` is numpy on
both sides and bitwise. The CUDA kernel itself is tested on the card
(``tests/test_torch_cuda_kernels.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bsr_spmm import blockify_edges as jax_blockify
from repro.kernels.bsr_spmm import bsr_spmm as jax_bsr_spmm
from repro.kernels.bsr_spmm import bsr_spmm_ref as jax_bsr_ref
from repro.kernels.bsr_spmm import spmm_edges_ref as jax_edges_ref
from repro.kernels.bsr_spmm.bsr_spmm import (
    bsr_spmm_kernel as jax_bsr_kernel,
)

from repro_torch.kernels import launch_counts
from repro_torch.kernels.bsr_spmm import (
    LAUNCHES, blockify_edges, bsr_spmm, bsr_spmm_kernel, bsr_spmm_np,
    bsr_spmm_ref, bsr_spmm_tolerance, spmm_edges_np, spmm_edges_ref,
)

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
# the reference kernel test's grid (tests/test_kernels.py TestBsrSpmm)
SHAPES = [(300, 2000, 64), (700, 5000, 128), (128, 400, 96), (513, 3000, 32)]


def _edges(rng, n, E):
    src = rng.integers(0, n, E)
    dst = rng.integers(0, n, E)
    w = rng.standard_normal(E).astype(np.float32)
    return src, dst, w


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_kernel(x, a, rows, cols, nb, block=128, d_block=128):
    return np.asarray(jax_bsr_spmm(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(rows), jnp.asarray(cols),
        nb, block=block, d_block=d_block, interpret=True))


def _jax_edges(src, dst, w, x, n):
    return np.asarray(jax_edges_ref(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), jnp.asarray(x),
        n))


@pytest.mark.parametrize("n,E,block", [
    (300, 2000, 128), (513, 3000, 64), (77, 500, 8), (128, 400, 128),
])
def test_blockify_edges_bitwise_vs_reference(n, E, block, rng):
    """Duplicate edges (summed in the block) and an n that is not a
    multiple of the block size give the reference's four outputs."""
    src, dst, w = _edges(rng, n, E)
    src = np.concatenate([src, src[:50]])
    dst = np.concatenate([dst, dst[:50]])
    w = np.concatenate([w, w[:50]])
    got = blockify_edges(src, dst, w, n, block=block)
    want = jax_blockify(src, dst, w, n, block=block)
    assert got[3] == want[3] == -(-n // block)
    for g, r in zip(got[:3], want[:3]):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert np.array_equal(g, r)
    assert np.all(np.diff(got[1]) >= 0)             # sorted by block row


@pytest.mark.parametrize("n,E,D", SHAPES)
def test_bsr_spmm_matches_jax_kernel_and_edge_oracles(n, E, D, rng):
    src, dst, w = _edges(rng, n, E)
    a, rows, cols, nb = blockify_edges(src, dst, w, n, block=128)
    x = rng.standard_normal((nb * 128, D)).astype(np.float32)
    kern = _jax_kernel(x, a, rows, cols, nb)
    edges = _jax_edges(src, dst, w, x, nb * 128)
    before = LAUNCHES["bsr_spmm"]
    got = bsr_spmm(*_t(x, a, rows, cols), nb)
    assert LAUNCHES["bsr_spmm"] == before            # plain version on CPU
    assert got.shape == (nb * 128, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), kern, **TOL)
    np.testing.assert_allclose(got.numpy(), edges, **TOL)
    np.testing.assert_allclose(
        got.numpy(), bsr_spmm_np(a, rows, cols, x.reshape(nb, 128, D),
                                 nb).reshape(nb * 128, D), **TOL)
    port_edges = spmm_edges_ref(*_t(src, dst, w, x), nb * 128)
    np.testing.assert_allclose(port_edges.numpy(), edges, **TOL)
    np.testing.assert_allclose(
        port_edges.numpy(), spmm_edges_np(src, dst, w, x, nb * 128), **TOL)


@pytest.mark.parametrize("n,E,D", SHAPES[:2])
def test_bsr_spmm_kernel_matches_jax_kernel_and_block_oracle(n, E, D, rng):
    """The raw (n_src_blocks, B, D) entry point against the JAX kernel and
    the JAX per-block oracle."""
    src, dst, w = _edges(rng, n, E)
    a, rows, cols, nb = blockify_edges(src, dst, w, n, block=128)
    xb = rng.standard_normal((nb, 128, D)).astype(np.float32)
    kern = np.asarray(jax_bsr_kernel(
        jnp.asarray(a), jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(xb), n_dst_blocks=nb, d_block=D, interpret=True))
    want = np.asarray(jax_bsr_ref(jnp.asarray(a), jnp.asarray(rows),
                                  jnp.asarray(cols), jnp.asarray(xb), nb))
    got = bsr_spmm_kernel(*_t(a, rows, cols, xb), nb)
    assert got.shape == (nb, 128, D)
    np.testing.assert_allclose(got.numpy(), kern, **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    ref = bsr_spmm_ref(*_t(a, rows, cols, xb), nb)
    assert torch.equal(ref, got)


def test_bf16_x(rng):
    n, E, D = 256, 1500, 64
    src, dst, w = _edges(rng, n, E)
    a, rows, cols, nb = blockify_edges(src, dst, w, n)
    x = rng.standard_normal((nb * 128, D)).astype(np.float32)
    x16 = jnp.asarray(x, jnp.bfloat16)
    kern = np.asarray(jax_bsr_spmm(
        x16, jnp.asarray(a), jnp.asarray(rows), jnp.asarray(cols), nb,
        interpret=True).astype(jnp.float32))
    edges = _jax_edges(src, dst, w, x, nb * 128)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = bsr_spmm(xt, *_t(a, rows, cols), nb)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), edges, **BF16_TOL)
    np.testing.assert_allclose(got.float().numpy(), kern, **BF16_TOL)
    # one rounding of the float32 sum of the bf16 inputs
    exact = bsr_spmm_np(a, rows, cols, xt.float().numpy().reshape(nb, 128, D),
                        nb).reshape(nb * 128, D)
    np.testing.assert_allclose(got.float().numpy(), exact, rtol=2 ** -8,
                               atol=1e-6)


def test_empty_block_rows_are_zero():
    """Block rows 1 and 3 (rows 8-15 and 24-31) have no nonzero block. The
    port writes zeros there, as the edge-list oracle gives; the reference
    Pallas kernel leaves them unwritten (NaN in interpret mode), so it is
    compared only on the rows it writes."""
    src = np.array([0, 9, 17, 3])
    dst = np.array([1, 2, 20, 21])
    w = np.ones(4, np.float32)
    a, rows, cols, nb = blockify_edges(src, dst, w, 32, block=8)
    assert nb == 4 and rows.tolist() == [0, 0, 2, 2]
    x = np.random.default_rng(0).standard_normal((32, 20)).astype(np.float32)
    got = bsr_spmm(*_t(x, a, rows, cols), nb, block=8).numpy()
    edges = _jax_edges(src, dst, w, x, 32)
    assert np.array_equal(got, edges)
    empty = np.r_[8:16, 24:32]
    assert not got[empty].any()
    kern = _jax_kernel(x, a, rows, cols, nb, block=8, d_block=8)
    assert kern.shape == (32, 20)
    written = np.r_[0:8, 16:24]
    assert np.array_equal(got[written], kern[written])


@pytest.mark.parametrize("n,E,D,block,d_block", [
    (200, 900, 7, 128, 128), (150, 700, 20, 64, 8), (40, 300, 20, 8, 16),
])
def test_ragged_feature_width(n, E, D, block, d_block, rng):
    """D not a multiple of the reference's d_block (which pads x); the port
    keeps D as it is."""
    src, dst, w = _edges(rng, n, E)
    a, rows, cols, nb = blockify_edges(src, dst, w, n, block=block)
    x = rng.standard_normal((nb * block, D)).astype(np.float32)
    got = bsr_spmm(*_t(x, a, rows, cols), nb, block=block)
    assert got.shape == (nb * block, D)
    kern = _jax_kernel(x, a, rows, cols, nb, block=block, d_block=d_block)
    np.testing.assert_allclose(got.numpy(), kern, **TOL)
    np.testing.assert_allclose(got.numpy(),
                               _jax_edges(src, dst, w, x, nb * block), **TOL)


@pytest.mark.parametrize("case", ["no_blocks", "one_block"])
def test_degenerate_block_counts(case, rng):
    n, D = 256, 16
    if case == "no_blocks":
        src = dst = np.zeros(0, np.int64)
        w = np.zeros(0, np.float32)
    else:                                   # every edge in block (1, 0)
        src = rng.integers(0, 128, 60)
        dst = rng.integers(128, 256, 60)
        w = rng.standard_normal(60).astype(np.float32)
    a, rows, cols, nb = blockify_edges(src, dst, w, n)
    assert a.shape[0] == (0 if case == "no_blocks" else 1)
    x = rng.standard_normal((n, D)).astype(np.float32)
    got = bsr_spmm(*_t(x, a, rows, cols), nb)
    want = _jax_edges(src, dst, w, x, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert not got[:128].any()


def test_plain_version_is_deterministic_and_launches_nothing(rng):
    n, E, D = 700, 5000, 48
    src, dst, w = _edges(rng, n, E)
    a, rows, cols, nb = blockify_edges(src, dst, w, n)
    x = rng.standard_normal((nb * 128, D)).astype(np.float32)
    args = _t(x, a, rows, cols)
    before = launch_counts()["bsr_spmm"]
    one = bsr_spmm(*args, nb)
    two = bsr_spmm(*args, nb)
    assert torch.equal(one, two)
    xb = args[0].view(nb, 128, D)
    assert torch.equal(bsr_spmm_ref(*args[1:], xb, nb),
                       one.view(nb, 128, D))
    e1 = spmm_edges_ref(*_t(src, dst, w, x), nb * 128)
    e2 = spmm_edges_ref(*_t(src, dst, w, x), nb * 128)
    assert torch.equal(e1, e2)
    assert launch_counts()["bsr_spmm"] == before == 0


def test_wrappers_refuse_unsorted_row_ids(rng):
    """The kernel finds a row's blocks by binary search in the sorted row
    ids, so both wrappers refuse unsorted ids on either device (here the
    CPU, where they would otherwise run the plain version)."""
    n, E, D = 513, 3000, 32
    src, dst, w = _edges(rng, n, E)
    a, rows, cols, nb = blockify_edges(src, dst, w, n)
    # move row 2's blocks to the front, keeping their order
    first = rows == 2
    perm = np.concatenate([np.nonzero(first)[0], np.nonzero(~first)[0]])
    x = torch.from_numpy(rng.standard_normal((nb * 128, D)).astype(np.float32))
    args = _t(a[perm], rows[perm], cols[perm])
    with pytest.raises(ValueError, match="sorted"):
        bsr_spmm_kernel(*args, x.view(nb, 128, D), nb)
    with pytest.raises(ValueError, match="sorted"):
        bsr_spmm(x, *args, nb)
    assert launch_counts()["bsr_spmm"] == 0


@pytest.mark.parametrize("control", [None, "bf16_x", "tf32_x"])
def test_tolerance_holds_plain_and_catches_reduced_precision(control, rng):
    """``bsr_spmm_tolerance`` (the card check's limit, ``(m_r + 1) 2^-23
    (|A||X|)_r`` over the row's nonzero entries) holds the plain version
    against the float64 oracle, and is tight enough that a product on x
    rounded to bf16 or to TF32's 10-bit mantissa leaves it."""
    n, E, D = 700, 5000, 64
    src, dst, w = _edges(rng, n, E)
    a, rows, cols, nb = blockify_edges(src, dst, w, n)
    x = rng.standard_normal((nb, 128, D)).astype(np.float32)
    a_t, r_t, c_t, x_t = _t(a, rows, cols, x)
    if control == "bf16_x":
        xq = x_t.bfloat16().float()
    elif control == "tf32_x":        # keep 10 of float32's 23 mantissa bits
        xq = (x_t.view(torch.int32) & ~((1 << 13) - 1)).view(torch.float32)
    else:
        xq = x_t
    got = bsr_spmm_ref(a_t, r_t, c_t, xq, nb).numpy()
    tol = bsr_spmm_tolerance(a_t, r_t, c_t, x_t, nb).numpy()
    err = np.abs(got - bsr_spmm_np(a, rows, cols, x, nb))
    assert bool(np.all(err <= tol)) == (control is None), \
        float((err / np.maximum(tol, 1e-30)).max())


def test_wrapper_refuses_bad_shapes():
    a = torch.zeros(2, 8, 8)
    ids = torch.zeros(2, dtype=torch.int32)
    x = torch.zeros(32, 4)
    with pytest.raises(ValueError, match="nnz, B, B"):
        bsr_spmm_kernel(torch.zeros(2, 8, 4), ids, ids, x.view(4, 8, 4), 4)
    with pytest.raises(ValueError, match="row_ids and col_ids"):
        bsr_spmm_kernel(a, ids[:1], ids, x.view(4, 8, 4), 4)
    with pytest.raises(ValueError, match="n_src_blocks, B=8"):
        bsr_spmm_kernel(a, ids, ids, x.view(2, 16, 4), 4)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bsr_spmm_kernel(a, ids, ids, x.view(4, 8, 4).double(), 4)
    with pytest.raises(ValueError, match="fewer than"):
        bsr_spmm(x[:30], a, ids, ids, 4, block=8)
    with pytest.raises(ValueError, match="blocks of 16"):
        bsr_spmm(x, a, ids, ids, 2, block=16)
    with pytest.raises(ValueError, match=r"\(n, D\)"):
        bsr_spmm(x.view(4, 8, 4), a, ids, ids, 4, block=8)


def test_partition_reorder_concentrates_blocks(small_graph_port):
    """Port twin of the reference's test: partition-contiguous reordering
    concentrates edge mass into diagonal blocks (what makes the BSR layout
    pay), and into fewer nonzero blocks."""
    from repro_torch.graph import reorder_by_partition, switching_aware_partition

    g = small_graph_port
    block = 256

    def diag_fraction(ei):
        return float(np.mean(ei[1] // block == ei[0] // block))

    ei = g.edge_index()
    res = switching_aware_partition(g, 8, max_iters=10)
    ro = reorder_by_partition(g, res.parts, 8)
    ei_ro = ro.graph.edge_index()
    assert diag_fraction(ei_ro) > diag_fraction(ei)
    w = np.ones(ei.shape[1], np.float32)
    nnz = blockify_edges(ei[0], ei[1], w, g.n_nodes, block=block)[0].shape[0]
    nnz_ro = blockify_edges(ei_ro[0], ei_ro[1], w, g.n_nodes,
                            block=block)[0].shape[0]
    assert nnz_ro <= nnz


@pytest.fixture(scope="module")
def small_graph_port():
    """The reference test's graph (``small_graph``), from the port's own
    graph modules."""
    from repro_torch.graph import kronecker_graph
    from repro_torch.graph.csr import add_self_loops

    return add_self_loops(kronecker_graph(2000, 8, seed=1))
