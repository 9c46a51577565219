"""The port's gather kernels: plain versions vs the reference Pallas
kernels (interpret mode) and oracles, the wrappers' CPU routing and checks,
and the dispatch modes.

The CUDA kernels themselves are held against the oracles on the card by
``tests/test_torch_cuda_kernels.py`` (marked ``cuda``) and ``chip_smoke.py``.

Tolerances: ``gather_rows`` is a copy, so bitwise. The plain
``gather_aggregate`` multiplies then adds (two roundings per edge) while the
reference kernel fuses them, so rtol = atol = 2e-6, the envelope of
``tests/test_kernel_dispatch.py``. The FMA oracle copy is bitwise.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.gather_scatter import ops as jops
from repro.kernels.gather_scatter import ref as jref

from repro_torch.core.counters import Counters
from repro_torch.kernels.dispatch import KernelDispatch, VALID_MODES
from repro_torch.kernels.gather_scatter import ops, ref


def _sorted_dst(rng, E, n_dst):
    return np.sort(rng.integers(0, n_dst, E)).astype(np.int32)


def _agg_inputs(rng, n, E, nd, D):
    table = rng.standard_normal((n, D), dtype=np.float32)
    erows = rng.integers(0, n, E).astype(np.int32)
    dst = _sorted_dst(rng, E, nd)
    w = rng.standard_normal(E, dtype=np.float32)
    return table, erows, dst, w


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------------- gather_rows
@pytest.mark.parametrize("n,r,D", [
    (64, 128, 16), (300, 77, 48), (9, 1, 200), (5, 3, 7), (257, 511, 130),
])
def test_gather_rows_plain_bitwise_vs_reference_kernel(n, r, D, rng):
    table = rng.standard_normal((n, D), dtype=np.float32)
    rows = rng.integers(0, n, r).astype(np.int32)
    want = np.asarray(jops.gather_rows(jnp.asarray(table), jnp.asarray(rows),
                                       interpret=True))
    got = ops.gather_rows(*_t(table, rows))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.gather_rows_ref(*_t(table, rows)).numpy(),
        jref.gather_rows_ref(table, rows),
    )


@pytest.mark.parametrize("R,D", [(0, 8), (4, 0)])
def test_gather_rows_degenerate_returns_zeros(R, D, rng):
    table = torch.from_numpy(rng.standard_normal((16, D), dtype=np.float32))
    rows = torch.zeros(R, dtype=torch.int32)
    out = ops.gather_rows(table, rows)
    assert out.shape == (R, D) and not torch.any(out)


# -------------------------------------------------------- gather_aggregate
@pytest.mark.parametrize("n,E,nd,D", [
    (64, 400, 32, 16), (128, 1000, 64, 48), (10, 30, 5, 129), (6, 1, 3, 8),
    (40, 90, 12, 7),                                   # D % 4 != 0
])
def test_gather_aggregate_plain_vs_reference_kernel(n, E, nd, D, rng):
    table, erows, dst, w = _agg_inputs(rng, n, E, nd, D)
    want = np.asarray(jops.gather_aggregate(
        *(jnp.asarray(a) for a in (table, erows, dst, w)), nd,
        interpret=True,
    ))
    got = ops.gather_aggregate(*_t(table, erows, dst, w), nd).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    # multiply-then-add: bitwise the reference's vectorized oracle
    np.testing.assert_array_equal(
        got, jref.gather_aggregate_ref(table, erows, dst, w, nd))


def test_fma_oracle_copy_is_bitwise_the_reference_oracle(rng):
    table, erows, dst, w = _agg_inputs(rng, 50, 300, 20, 24)
    np.testing.assert_array_equal(
        ref.gather_aggregate_ref_fma(table, erows, dst, w, 20),
        jref.gather_aggregate_ref_fma(table, erows, dst, w, 20),
    )
    want = np.asarray(jops.gather_aggregate(
        *(jnp.asarray(a) for a in (table, erows, dst, w)), 20,
        interpret=True,
    ))
    np.testing.assert_array_equal(
        ref.gather_aggregate_ref_fma(table, erows, dst, w, 20), want)


def _double_rounding_case():
    """Two edges into one row where the float64 route rounds twice: the
    first edge makes acc = 2^70 + 2^47 (an odd float32 mantissa), the
    second adds (2^23 + 1)(2^23 - 1) = 2^46 - 1, just under the float32
    midpoint 2^70 + 2^47 + 2^46. One rounding gives 2^70 + 2^47; the
    float64 sum rounds up onto the midpoint, and then ties-to-even gives
    2^70 + 2^48."""
    table = np.array([[1.0], [2.0 ** 23 - 1]], np.float32)
    erows = np.array([0, 1], np.int32)
    dst = np.zeros(2, np.int32)
    w = np.array([2.0 ** 70 + 2.0 ** 47, 2.0 ** 23 + 1], np.float32)
    return table, erows, dst, w


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("n,E,nd,D", [
    (64, 400, 32, 16), (10, 30, 5, 129), (6, 1, 3, 8), (50, 300, 20, 24),
])
def test_exact_fma_oracle_matches_the_f64_oracles(n, E, nd, D, threads, rng):
    """Where no float64 sum lands on a float32 tie (none does here), the
    exact oracle is bitwise the float64 one and the reference package's."""
    table, erows, dst, w = _agg_inputs(rng, n, E, nd, D)
    got, twice = ref.gather_aggregate_fma_np(table, erows, dst, w, nd,
                                             threads=threads)
    assert twice == 0
    np.testing.assert_array_equal(
        got, ref.gather_aggregate_ref_fma(table, erows, dst, w, nd))
    np.testing.assert_array_equal(
        got, jref.gather_aggregate_ref_fma(table, erows, dst, w, nd))


def test_exact_fma_oracle_resolves_a_double_rounding():
    table, erows, dst, w = _double_rounding_case()
    got, twice = ref.gather_aggregate_fma_np(table, erows, dst, w, 1)
    assert twice == 1
    assert got[0, 0] == np.float32(2.0 ** 70 + 2.0 ** 47)
    assert ref.fma32_exact(w[1], table[1, 0], w[0]) == got[0, 0]
    # the float64 route (this port's copy and the reference's) rounds twice
    for oracle in (ref.gather_aggregate_ref_fma, jref.gather_aggregate_ref_fma):
        assert oracle(table, erows, dst, w, 1)[0, 0] == np.float32(
            2.0 ** 70 + 2.0 ** 48)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_fma_oracle_vs_rational_arithmetic(seed):
    """Against ``fma32_exact`` (exact fractions) step by step, on chains
    built to hit float32 ties: products of values with few mantissa bits
    (multiples of 2^-6 in [-2, 2)) against accumulators of every size."""
    rng = np.random.default_rng(seed)
    E, D = 60, 40
    table = (rng.integers(-128, 128, (E, D)) / 64).astype(np.float32)
    w = (rng.integers(-128, 128, E) * 2.0 ** rng.integers(-30, 30, E)
         ).astype(np.float32)
    dst = np.zeros(E, np.int32)
    got, _ = ref.gather_aggregate_fma_np(table, np.arange(E, dtype=np.int32),
                                         dst, w, 1)
    for c in range(D):
        acc = np.float32(0)
        for e in range(E):
            acc = ref.fma32_exact(w[e], table[e, c], acc)
        assert got[0, c] == acc, c


def test_fma32_exact_rounds_once_to_nearest_even():
    one = np.float32(1.0)
    # 1 + 2^-24 is a float32 tie: to even (1.0); 1 + 3 * 2^-24 to 1 + 2^-22
    assert ref.fma32_exact(np.float32(2.0 ** -24), one, one) == one
    assert ref.fma32_exact(np.float32(3 * 2.0 ** -24), one, one) == \
        np.float32(1 + 2.0 ** -22)
    # just above the tie: up
    assert ref.fma32_exact(np.float32(2.0 ** -24 + 2.0 ** -47), one, one) \
        == np.float32(1 + 2.0 ** -23)


def test_exact_fma_oracle_keeps_edge_order_and_empty_rows(rng):
    table, erows, dst, w = _agg_inputs(rng, 30, 200, 12, 5)
    dst[dst == 4] = 5                                   # row 4 has no edge
    perm = rng.permutation(dst.size)                    # unsorted dst
    got, _ = ref.gather_aggregate_fma_np(table, erows[perm], dst[perm],
                                         w[perm], 12)
    np.testing.assert_array_equal(
        got, ref.gather_aggregate_ref_fma(table, erows[perm], dst[perm],
                                          w[perm], 12))
    assert not got[4].any()


def test_gather_aggregate_degenerate_returns_zeros(rng):
    table = torch.from_numpy(rng.standard_normal((8, 16), dtype=np.float32))
    e = torch.zeros(0, dtype=torch.int32)
    out = ops.gather_aggregate(table, e, e, torch.zeros(0), 5)
    assert out.shape == (5, 16) and not torch.any(out)
    assert ops.gather_aggregate(table, e, e, torch.zeros(0), 0).shape == (0, 16)
    one = ops.gather_aggregate(table, torch.tensor([3], dtype=torch.int32),
                               torch.tensor([1], dtype=torch.int32),
                               torch.tensor([2.0]), 2)
    np.testing.assert_array_equal(one[1].numpy(), (2.0 * table[3]).numpy())
    assert not torch.any(one[0])


def test_wrappers_check_shapes(rng):
    t = torch.zeros(4, 4)
    with pytest.raises(ValueError):
        ops.gather_rows(t, torch.zeros(2, 2, dtype=torch.int32))
    with pytest.raises(ValueError, match="lengths differ"):
        ops.gather_aggregate(t, torch.zeros(3, dtype=torch.int32),
                             torch.zeros(2, dtype=torch.int32),
                             torch.zeros(3), 2)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing(
    rng, monkeypatch,
):
    def boom(*a, **k):
        raise AssertionError("kernel library touched for a CPU tensor")

    monkeypatch.setattr(ops, "_lib", boom)
    ops.reset_launches()
    table, erows, dst, w = _agg_inputs(rng, 30, 60, 10, 8)
    ops.gather_rows(*_t(table, erows))
    ops.gather_aggregate(*_t(table, erows, dst, w), 10)
    assert ops.LAUNCHES == {"gather_rows": 0, "gather_aggregate": 0,
                            "scatter_add": 0}


# ----------------------------------------------------------------- dispatch
def test_dispatch_modes_resolve_and_record_spans(rng):
    with pytest.raises(ValueError):
        KernelDispatch("pallas", device="cpu")
    assert VALID_MODES == ("auto", "reference", "kernel", "kernel-fused")
    assert KernelDispatch("auto", device="cpu").mode == "reference"
    c = Counters()
    kd = KernelDispatch("kernel", c, device="cpu")
    assert kd.use_kernels and not kd.fused_aggregate
    assert KernelDispatch("kernel-fused", device="cpu").fused_aggregate
    table, erows, _, _ = _agg_inputs(rng, 20, 40, 5, 8)
    kd.gather_rows(*_t(table, erows))
    assert c.phase_seconds["kernel:gather_rows.ref"] > 0


def _unit_topos(rng, n_stack, n_dst, E, pad):
    """A plan-shaped unit: real edges sorted by dst, then a padding tail
    (weight 0, mask 0, pointing at slot 0) — both packages' topologies."""
    import jax
    from repro.models.gnn import layers as jl

    from repro_torch.models.gnn import layers as tl

    src = rng.integers(0, n_stack - 1, E).astype(np.int32)
    dst = _sorted_dst(rng, E, n_dst)
    ew = rng.random(E).astype(np.float32)
    z = np.zeros(pad, np.int32)
    src, dst = np.concatenate([src, z]), np.concatenate([dst, z])
    ew = np.concatenate([ew, np.zeros(pad, np.float32)])
    mask = np.concatenate([np.ones(E, np.float32), np.zeros(pad, np.float32)])
    deg = np.ones(n_dst, np.float32)
    self_ = np.zeros(n_dst, np.int32)
    arrays = (src, dst, ew, mask, deg, self_)
    j = jl.LocalTopo(*(jax.numpy.asarray(a) for a in arrays[:2]), n_dst,
                     *(jax.numpy.asarray(a) for a in arrays[2:]))
    t = tl.LocalTopo(*(torch.from_numpy(a) for a in arrays[:2]), n_dst,
                     *(torch.from_numpy(a) for a in arrays[2:]),
                     n_real_edges=E)
    return j, t


@pytest.mark.parametrize("activate", [True, False])
def test_fused_forward_matches_reference_fused_dispatch(activate, rng):
    """The port's kernel-fused GCN forward over a staged stack vs the
    reference's ``pallas-fused`` one (interpret mode), same weights, within
    1e-5 (the reference fuses each edge's multiply-add, the plain version
    rounds twice, and XLA:CPU and ATen order the matmul differently); and
    dropping the padding tail leaves the bits of the port's reference-mode
    forward (which walks the padding) unchanged."""
    import jax
    from repro.kernels.dispatch import KernelDispatch as JKernelDispatch
    from repro.models.gnn.layers import get_gnn as jax_get_gnn

    from repro_torch.models.gnn.layers import get_gnn
    from repro_torch.params import params_from_jax

    n_stack, n_dst, E, pad, d_in, d_out = 90, 16, 300, 212, 24, 8
    stack = rng.standard_normal((n_stack, d_in)).astype(np.float32)
    stack[-1] = 0
    idx = rng.integers(0, n_stack, 64).astype(np.int32)
    jtopo, ttopo = _unit_topos(rng, 64, n_dst, E, pad)
    jp = {"lin": {"w": rng.standard_normal((d_in, d_out)).astype(np.float32),
                  "b": rng.standard_normal(d_out).astype(np.float32)}}
    jf = JKernelDispatch("pallas-fused").fused_forward_fn(
        jax_get_gnn("gcn"), activate)
    want = np.asarray(jf(jax.tree_util.tree_map(jnp.asarray, jp),
                         jnp.asarray(stack), jnp.asarray(idx), jtopo))
    layer = params_from_jax([jp], device="cpu")[0]
    f = KernelDispatch("kernel-fused", device="cpu").fused_forward_fn(
        get_gnn("gcn"), activate)
    with torch.no_grad():
        got = f(layer, *_t(stack, idx), ttopo)
        padded = KernelDispatch("reference", device="cpu").fused_forward_fn(
            get_gnn("gcn"), activate)(layer, *_t(stack, idx), ttopo)
    assert torch.equal(got, padded)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
