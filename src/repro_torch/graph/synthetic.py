"""Synthetic graph generators (deterministic, numpy-only).

Mirrors the paper's evaluation graphs: Kronecker/R-MAT power-law graphs
(Leskovec et al. 2010) for scaling studies (Table 2 / Appendix M), plus
Watts-Strogatz for the non-power-law robustness check (Appendix T).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.csr import CSRGraph, coo_to_csr, symmetrize


def kronecker_graph(
    n_nodes: int,
    avg_degree: int = 10,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> CSRGraph:
    """R-MAT style Kronecker graph with power-law degree distribution."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(n_nodes, 2))))
    n = n_nodes
    n_edges = n_nodes * avg_degree
    d = 1.0 - a - b - c
    p_right = b + d  # P(bit_src=1) at each level depends on quadrant probs
    # Sample each bit level independently (standard R-MAT without noise
    # smoothing): quadrant choice per level per edge.
    u = rng.random((scale, n_edges))
    v = rng.random((scale, n_edges))
    # quadrant: src_bit = u > (a+b on top half boundary)... derive from joint:
    # P(00)=a, P(01)=b, P(10)=c, P(11)=d. Sample joint via 2D inverse.
    r = rng.random((scale, n_edges))
    src_bit = (r >= a + b).astype(np.int64)  # rows c+d
    # conditional col bit
    top = r < a + b
    col_bit = np.where(
        top,
        (r >= a).astype(np.int64),  # within top: [0,a)->0, [a,a+b)->1
        (r >= a + b + c).astype(np.int64),  # within bottom
    )
    del u, v
    powers = (1 << np.arange(scale, dtype=np.int64))[:, None]
    src = (src_bit * powers).sum(axis=0) % n
    dst = (col_bit * powers).sum(axis=0) % n
    # drop self loops, keep dedupe to coo_to_csr
    keep = src != dst
    g = coo_to_csr(src[keep], dst[keep], n)
    return symmetrize(g)


def watts_strogatz(
    n_nodes: int, k: int = 16, p_rewire: float = 0.1, seed: int = 0
) -> CSRGraph:
    """Ring lattice with k neighbors, random rewiring (non-power-law)."""
    rng = np.random.default_rng(seed)
    half = k // 2
    base = np.arange(n_nodes, dtype=np.int64)
    srcs, dsts = [], []
    for off in range(1, half + 1):
        dst = (base + off) % n_nodes
        rewire = rng.random(n_nodes) < p_rewire
        dst = np.where(rewire, rng.integers(0, n_nodes, n_nodes), dst)
        srcs.append(base)
        dsts.append(dst)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    keep = src != dst
    return symmetrize(coo_to_csr(src[keep], dst[keep], n_nodes))


def erdos_renyi(n_nodes: int, avg_degree: int = 10, seed: int = 0) -> CSRGraph:
    rng = np.random.default_rng(seed)
    n_edges = n_nodes * avg_degree // 2
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes, n_edges)
    keep = src != dst
    return symmetrize(coo_to_csr(src[keep], dst[keep], n_nodes))


def random_features(
    n_nodes: int, dim: int, seed: int = 0, dtype=np.float32
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_nodes, dim)).astype(dtype) * 0.1


def random_labels(n_nodes: int, n_classes: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_classes, n_nodes).astype(np.int32)
