"""The traffic's graph: an R-MAT power-law graph.

A copy of the method of ``repro_torch.graph.synthetic.kronecker_graph``
(Leskovec et al. 2010; one quadrant draw per bit level and edge, no noise
smoothing), symmetrised and given a self-loop on every node, as the port's
``add_self_loops(kronecker_graph(...))``. The graph is the traffic's
dataset: it comes from the traffic's fixed ``structure_seed``, the same in
every run, as a deployment trains on one graph. Only numpy: the
yardstick does not depend on the program it measures.
"""
from __future__ import annotations

import numpy as np


def csr_from_pairs(src: np.ndarray, dst: np.ndarray, n: int):
    """In-edge CSR ``(indptr int64 (n+1,), indices int32 (E,))`` of the
    deduplicated ``(src, dst)`` pairs, destination-major, sources sorted."""
    key = np.unique(dst.astype(np.int64) * n + src.astype(np.int64))
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(key // n, minlength=n), out=indptr[1:])
    return indptr, (key % n).astype(np.int32)


def rmat_graph(n_nodes: int, avg_degree: int, seed: int, a: float, b: float,
               c: float):
    """``n_nodes * avg_degree`` R-MAT draws with quadrant probabilities
    ``a, b, c, 1 - a - b - c``; drawn self-loops are dropped, every edge is
    mirrored, one self-loop per node is added and duplicates merge.
    Returns the in-edge CSR ``(indptr, indices)``."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n_nodes, 2))))
    n_draws = n_nodes * avg_degree
    src = np.zeros(n_draws, np.int64)
    dst = np.zeros(n_draws, np.int64)
    for level in range(scale):
        r = rng.random(n_draws)
        src_bit = r >= a + b
        col_bit = np.where(src_bit, r >= a + b + c, r >= a)
        src += src_bit.astype(np.int64) << level
        dst += col_bit.astype(np.int64) << level
    src %= n_nodes
    dst %= n_nodes
    keep = src != dst
    src, dst = src[keep], dst[keep]
    loops = np.arange(n_nodes, dtype=np.int64)
    return csr_from_pairs(np.concatenate([src, dst, loops]),
                          np.concatenate([dst, src, loops]), n_nodes)

