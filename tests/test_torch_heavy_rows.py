"""The row plan of the ``gather_aggregate`` and ``edge_softmax`` kernels
(``repro_torch.kernels.heavy_rows``) on CPU tensors: row ranges, the heavy
list's coverage, its data-independent size, and its order.

The kernels read the plan on the card; ``tests/test_torch_cuda_kernels.py``
holds them against the oracles there with rows above the threshold.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.edge_softmax import ops as es_ops
from repro_torch.kernels.gather_scatter import ops as gs_ops
from repro_torch.kernels.heavy_rows import (
    HUGE_FACTOR, PLAN_TILE, heavy_slots, plan_rows, plan_scratch,
)


def _power_law_dst(rng, n_dst, E, hubs=()):
    """Sorted destination ids: ``E`` Zipf-like ids in ``[0, n_dst)`` plus,
    for each ``(row, k)`` in ``hubs``, ``k`` more edges into ``row``."""
    ids = np.minimum(rng.zipf(1.6, E) - 1, n_dst - 1)
    ids = rng.permutation(n_dst)[ids]
    extra = [np.full(k, r) for r, k in hubs]
    return torch.from_numpy(
        np.sort(np.concatenate([ids, *extra])).astype(np.int32))


def _degrees(dst, n_dst):
    return np.bincount(dst.numpy(), minlength=n_dst)


@pytest.mark.parametrize("n_dst,E,T,hubs", [
    (500, 4000, 16, ()), (300, 2000, 64, ((7, 300), (250, 90))),
    (64, 64, 0, ()), (1000, 20000, 256, ((999, 3000),)), (40, 500, 3, ()),
])
def test_starts_are_each_rows_edge_range(n_dst, E, T, hubs, rng):
    dst = _power_law_dst(rng, n_dst, E, hubs)
    starts, _ = plan_rows(dst, n_dst, T)
    assert starts.dtype == torch.int64 and starts.shape == (n_dst + 1,)
    want = np.concatenate([[0], np.cumsum(_degrees(dst, n_dst))])
    np.testing.assert_array_equal(starts.numpy(), want)


@pytest.mark.parametrize("n_dst,E,T,hubs", [
    (500, 4000, 16, ()), (300, 2000, 64, ((7, 300), (250, 90))),
    (64, 64, 0, ()), (1000, 20000, 256, ((999, 3000), (3, 257))),
    (40, 500, 3, ()), (10, 100, 9, ((0, 10), (9, 11))),
])
def test_heavy_list_covers_every_heavy_row_exactly_once(n_dst, E, T, hubs,
                                                        rng):
    dst = _power_law_dst(rng, n_dst, E, hubs)
    starts, heavy = plan_rows(dst, n_dst, T)
    deg = _degrees(dst, n_dst)
    assert heavy.dtype == torch.int64
    want = np.flatnonzero(deg > T)
    listed = heavy.numpy()[:want.size]
    assert len(set(listed.tolist())) == listed.size          # no row twice
    np.testing.assert_array_equal(np.sort(listed), want)
    # the rows of more than HUGE_FACTOR * T edges first, then the rest of
    # the heavy rows, each in row order; -1 to the end (the kernels stop
    # at the first -1)
    huge = deg[listed] > HUGE_FACTOR * T
    n_huge = int(huge.sum())
    assert huge[:n_huge].all() and not huge[n_huge:].any()
    assert np.all(np.diff(listed[:n_huge]) > 0)
    assert np.all(np.diff(listed[n_huge:]) > 0)
    assert np.all(heavy.numpy()[want.size:] == -1)


@pytest.mark.parametrize("E,n_dst,T", [(4000, 500, 16), (20000, 1000, 256),
                                       (100, 1000, 0), (999, 3, 100)])
def test_heavy_list_size_depends_only_on_edges_rows_and_threshold(E, n_dst, T,
                                                                  rng):
    sizes = set()
    for hubs in [(), ((0, E // 2),), ((n_dst - 1, E // 3), (1, E // 4))]:
        base = E - sum(k for _, k in hubs)
        dst = _power_law_dst(rng, n_dst, base, hubs)
        assert dst.shape[0] == E
        sizes.add(plan_rows(dst, n_dst, T)[1].shape[0])
        uniform = torch.from_numpy(
            np.sort(rng.integers(0, n_dst, E)).astype(np.int32))
        sizes.add(plan_rows(uniform, n_dst, T)[1].shape[0])
    assert sizes == {heavy_slots(E, n_dst, T)}
    assert heavy_slots(E, n_dst, T) == min(E // (T + 1), n_dst)


def test_plan_is_empty_when_no_row_is_heavy(rng):
    # fewer edges than the threshold: no slot at all
    dst = torch.from_numpy(np.sort(rng.integers(0, 50, 200)).astype(np.int32))
    assert plan_rows(dst, 50, 256)[1].numel() == 0
    # slots, but every row at or under the threshold: all -1, so the first
    # entry already stops the kernels
    dst = torch.arange(100, dtype=torch.int32).repeat_interleave(4)
    starts, heavy = plan_rows(dst, 100, 4)
    assert heavy.numel() == heavy_slots(400, 100, 4) == 80
    assert heavy.tolist() == [-1] * 80
    # no edges at all
    starts, heavy = plan_rows(torch.zeros(0, dtype=torch.int32), 7, 0)
    assert heavy.numel() == 0 and starts.tolist() == [0] * 8


def test_heavy_and_ordinary_work_cover_every_row_once(rng):
    """The kernels' split of the rows, on the plan: the heavy grid takes
    (row, slab) items down the list until the first -1; the row grid takes
    every row with ``T`` edges or fewer. Together each row's every slab
    exactly once."""
    n_dst, T, D, slab = 400, 32, 100, 32
    dst = _power_law_dst(rng, n_dst, 6000, ((5, 900), (399, 40)))
    starts, heavy = plan_rows(dst, n_dst, T)
    deg = (starts[1:] - starts[:-1]).numpy()
    n_slab = -(-D // slab)
    seen = {}
    for i in range(heavy.numel() * n_slab):
        row = int(heavy[i // n_slab])
        if row < 0:
            break
        c0 = (i % n_slab) * slab
        for c in range(c0, min(c0 + slab, D)):
            seen[(row, c)] = seen.get((row, c), 0) + 1
    for row in np.flatnonzero(deg <= T):
        for c in range(D):
            seen[(int(row), c)] = seen.get((int(row), c), 0) + 1
    assert len(seen) == n_dst * D and set(seen.values()) == {1}


def test_plan_rejects_bad_arguments():
    with pytest.raises(ValueError, match="1-D"):
        plan_rows(torch.zeros(2, 2, dtype=torch.int32), 3, 4)
    with pytest.raises(ValueError, match=">= 0"):
        plan_rows(torch.zeros(2, dtype=torch.int32), 3, -1)


@pytest.mark.parametrize("mod", [gs_ops, es_ops])
def test_wrappers_state_their_threshold(mod):
    assert isinstance(mod.HEAVY_EDGES, int) and mod.HEAVY_EDGES > 0
    assert str(mod.HEAVY_EDGES) in (
        mod.gather_aggregate.__doc__ if mod is gs_ops
        else mod.edge_softmax.__doc__)


@pytest.mark.parametrize("n_dst,tiles", [(40, 1), (1024, 1), (3000, 3)])
def test_plan_scratch_has_the_plans_sizes(n_dst, tiles):
    """Row starts, then the list's slots and two counts a planner tile."""
    starts, heavy = plan_scratch(10000, n_dst, 9, torch.device("cpu"))
    assert starts.shape == (n_dst + 1,)
    assert heavy.shape == (heavy_slots(10000, n_dst, 9) + 2 * tiles,)
    assert tiles == -(-n_dst // PLAN_TILE)
    assert starts.dtype == heavy.dtype == torch.int64


def test_row_plan_on_cpu_is_the_plain_version(rng):
    dst = _power_law_dst(rng, 300, 5000, ((4, 2000),))
    for a, b in zip(gs_ops.row_plan(dst, 300, 20), plan_rows(dst, 300, 20)):
        assert torch.equal(a, b)
