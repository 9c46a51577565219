"""The port's ``scatter_add`` (the backward's ∇A write-back): the plain
version vs the reference Pallas kernel (interpret mode) and the ``np.add.at``
oracle, the dispatcher's host paths vs the reference's, and the wrapper's
refusals.

All comparisons are bitwise: the kernel, its plain version and the oracle
add each value row once, in input order. The CUDA kernel itself is held
against the oracle on the card by ``tests/test_torch_cuda_kernels.py``
(marker ``cuda``) and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.dispatch import scatter_add_rows_ref as jax_scatter_rows_ref
from repro.kernels.gather_scatter import ops as jops
from repro.kernels.gather_scatter import ref as jref

from repro_torch.core.counters import Counters
from repro_torch.kernels.dispatch import KernelDispatch, scatter_add_rows_ref
from repro_torch.kernels.gather_scatter import ops, ref


def _inputs(rng, n, r, D, dup=True):
    base = rng.standard_normal((n, D), dtype=np.float32)
    rows = (rng.integers(0, n, r) if dup
            else rng.choice(n, size=r, replace=False))
    rows = np.sort(rows).astype(np.int32)
    values = rng.standard_normal((r, D), dtype=np.float32)
    return base, rows, values


@pytest.mark.parametrize("n,r,D", [
    (64, 200, 16),     # many duplicates
    (300, 77, 48),
    (10, 1, 7),        # one row, D % 4 != 0
    (40, 90, 7),       # D % 4 != 0 with duplicates
    (257, 511, 130),
    (50, 20, 8),       # rows only in the head: an untouched tail
])
def test_plain_bitwise_vs_oracle_and_reference_kernel(n, r, D, rng):
    base, rows, values = _inputs(rng, n, r, D)
    if (n, r) == (50, 20):
        rows = np.sort(rng.integers(0, 10, r)).astype(np.int32)
    want = jref.scatter_add_ref(base, rows, values)
    np.testing.assert_array_equal(ref.scatter_add_ref_np(base, rows, values),
                                  want)
    pallas = np.asarray(jops.scatter_add(
        jnp.asarray(base), jnp.asarray(rows), jnp.asarray(values),
        interpret=True))
    np.testing.assert_array_equal(pallas, want)
    got = torch.from_numpy(base.copy())
    out = ops.scatter_add_(got, *(torch.from_numpy(a) for a in (rows, values)))
    assert out is got                       # in place
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.scatter_add_ref(torch.from_numpy(base.copy()),
                            torch.from_numpy(rows),
                            torch.from_numpy(values)).numpy(), want)


@pytest.mark.parametrize("R,D", [(0, 8), (4, 0)])
def test_empty_scatter_leaves_base(R, D, rng):
    base = torch.from_numpy(rng.standard_normal((16, D), dtype=np.float32))
    before = base.clone()
    out = ops.scatter_add_(base, torch.zeros(R, dtype=torch.int32),
                           torch.zeros((R, D)))
    assert out is base and torch.equal(base, before)


def test_wrapper_refusals():
    b = torch.zeros(4, 4)
    with pytest.raises(ValueError):
        ops.scatter_add_(b, torch.zeros(2, 2, dtype=torch.int32),
                         torch.zeros(2, 4))
    with pytest.raises(ValueError):
        ops.scatter_add_(torch.zeros(4), torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, 4))
    with pytest.raises(ValueError, match="do not match"):
        ops.scatter_add_(b, torch.zeros(2, dtype=torch.int32),
                         torch.zeros(3, 4))
    # the launch-side checks (dtype, device, contiguity) of a CUDA base
    with pytest.raises(TypeError):
        ops._check("rows", torch.zeros(2, dtype=torch.int64), torch.int32, 1,
                   torch.device("cpu"))
    with pytest.raises(ValueError, match="expected"):
        ops._check("values", torch.zeros(2, 4), torch.float32, 2,
                   torch.device("meta"))


def test_cpu_tensor_runs_plain_version_and_launches_nothing(rng, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel library touched for a CPU tensor")

    monkeypatch.setattr(ops, "_lib", boom)
    ops.reset_launches()
    base, rows, values = _inputs(rng, 30, 40, 8)
    ops.scatter_add_(*(torch.from_numpy(a) for a in (base, rows, values)))
    assert ops.LAUNCHES["scatter_add"] == 0


# ----------------------------------------------------------------- dispatch
def _row_cases(rng):
    """Row sets of the engine's shapes (sorted unique, contiguous runs, the
    loss layer's arange), plus an unsorted one and an empty one."""
    return {
        "sorted_unique": np.sort(rng.choice(100, 37, replace=False)),
        "contiguous": np.arange(20, 45),
        "arange": np.arange(100),
        "single": np.array([7]),
        "unsorted_unique": rng.choice(100, 30, replace=False),
        "empty": np.zeros(0, np.int64),
    }


@pytest.mark.parametrize("case", ["sorted_unique", "contiguous", "arange",
                                  "single", "unsorted_unique", "empty"])
@pytest.mark.parametrize("mode", ["reference", "kernel"])
def test_dispatch_matches_reference_host_scatter(case, mode, rng):
    rows = _row_cases(rng)[case]
    D = 12
    base = rng.standard_normal((100, D), dtype=np.float32)
    values = rng.standard_normal((rows.size, D), dtype=np.float32)
    want = base.copy()
    jax_scatter_rows_ref(want, rows, values)
    np.testing.assert_array_equal(want,
                                  jref.scatter_add_ref(base, rows, values))
    mine = base.copy()
    scatter_add_rows_ref(mine, rows, values)
    np.testing.assert_array_equal(mine, want)
    c = Counters()
    kd = KernelDispatch(mode, c, device="cpu")
    got = base.copy()
    kd.scatter_add_rows(got, rows, values)
    np.testing.assert_array_equal(got, want)
    if rows.size:
        assert c.phase_seconds["kernel:scatter_add.ref"] > 0


def test_dispatch_unsorted_duplicates_keep_input_order(rng):
    """Unsorted rows with duplicates through the kernel path: the stable
    sort keeps each row's values in input order, so the result is the
    sequential ``np.add.at`` bitwise (the host reduceat path sums a
    segment first and may differ by an ulp)."""
    rows = rng.integers(0, 20, 80)
    base = rng.standard_normal((20, 9), dtype=np.float32)
    values = (rng.standard_normal((80, 9)) * 1e3).astype(np.float32)
    got = base.copy()
    KernelDispatch("kernel", device="cpu").scatter_add_rows(got, rows, values)
    np.testing.assert_array_equal(got, ref.scatter_add_ref_np(base, rows,
                                                              values))
