"""The traffic's R-MAT graph: deterministic by seed, symmetric, one
self-loop a node, the size the configurations expect."""
import numpy as np
import pytest

from perfbench.rmat import csr_from_pairs, rmat_graph

ABC = (0.57, 0.19, 0.19)


def test_same_seed_same_graph_and_other_seed_other_graph():
    big = 2**31 + 987654321
    a = rmat_graph(4096, 12, big, *ABC)
    b = rmat_graph(4096, 12, big, *ABC)
    c = rmat_graph(4096, 12, big + 1, *ABC)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 5])
def test_symmetric_with_self_loops_and_sorted(seed):
    n = 2048
    indptr, indices = rmat_graph(n, 12, seed, *ABC)
    dst = np.repeat(np.arange(n), np.diff(indptr))
    pairs = set(zip(indices.tolist(), dst.tolist()))
    assert all((d, s) in pairs for s, d in pairs)
    assert all((v, v) in pairs for v in range(n))
    assert len(pairs) == indices.size
    for v in (0, 1, n // 2, n - 1):
        row = indices[indptr[v]:indptr[v + 1]]
        assert np.all(np.diff(row) > 0)


def test_edges_per_node_near_igbm_degree():
    # the cells' 65,536 nodes at 12 draws a node: ~1.46 M edges, phase C's
    indptr, indices = rmat_graph(65536, 12, 1, *ABC)
    assert 1.40e6 < indices.size < 1.52e6


def test_csr_from_pairs_dedupes():
    indptr, indices = csr_from_pairs(np.array([1, 1, 0, 2]),
                                     np.array([0, 0, 2, 2]), 3)
    assert indptr.tolist() == [0, 1, 1, 3]
    assert indices.tolist() == [1, 0, 2]

