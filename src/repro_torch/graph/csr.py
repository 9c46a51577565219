"""CSR graph structures.

Message passing in this package is built on edge-index gather and
segment-sum ops over torch tensors. The host-side graph representation is CSR
over **incoming** edges (dst -> sorted src list), which is what the plan
builder and the partitioner ("SrcPtr"/"DstIdx" in the paper's Figure 7)
consume.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """In-edge CSR: for vertex v, sources are ``indices[indptr[v]:indptr[v+1]]``.

    ``indptr``  : int64 (n_nodes+1,)
    ``indices`` : int32 (n_edges,) source vertex ids
    """

    indptr: np.ndarray
    indices: np.ndarray
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    def in_degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.n_nodes).astype(np.int64)

    def edge_index(self) -> np.ndarray:
        """COO (2, E): row 0 = src, row 1 = dst (dst-major sorted)."""
        dst = np.repeat(
            np.arange(self.n_nodes, dtype=np.int32), np.diff(self.indptr)
        )
        return np.stack([self.indices.astype(np.int32), dst])

    def nbytes(self) -> int:
        return self.indptr.nbytes + self.indices.nbytes

    def validate(self) -> None:
        assert self.indptr.shape == (self.n_nodes + 1,)
        assert self.indptr[0] == 0 and self.indptr[-1] == self.n_edges
        assert np.all(np.diff(self.indptr) >= 0)
        if self.n_edges:
            assert self.indices.min() >= 0 and self.indices.max() < self.n_nodes


def coo_to_csr(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> CSRGraph:
    """Build in-edge CSR from a COO edge list (deduplicated, dst-major)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    # dedupe (dst, src) pairs
    key = dst * n_nodes + src
    key = np.unique(key)
    dst_u = (key // n_nodes).astype(np.int64)
    src_u = (key % n_nodes).astype(np.int32)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(indptr, dst_u + 1, 1)
    np.cumsum(indptr, out=indptr)
    return CSRGraph(indptr=indptr, indices=src_u, n_nodes=n_nodes)


def add_self_loops(g: CSRGraph) -> CSRGraph:
    ei = g.edge_index()
    loop = np.arange(g.n_nodes, dtype=np.int64)
    src = np.concatenate([ei[0].astype(np.int64), loop])
    dst = np.concatenate([ei[1].astype(np.int64), loop])
    return coo_to_csr(src, dst, g.n_nodes)


def symmetrize(g: CSRGraph) -> CSRGraph:
    ei = g.edge_index()
    src = np.concatenate([ei[0], ei[1]]).astype(np.int64)
    dst = np.concatenate([ei[1], ei[0]]).astype(np.int64)
    return coo_to_csr(src, dst, g.n_nodes)


def gcn_norm_coeffs(g: CSRGraph, eps: float = 1e-12) -> np.ndarray:
    """Symmetric GCN normalization 1/sqrt(d_src * d_dst) per edge (float32, E)."""
    deg = g.in_degrees().astype(np.float64)
    deg = np.maximum(deg, 1.0)
    dst = np.repeat(np.arange(g.n_nodes), np.diff(g.indptr))
    coeff = 1.0 / np.sqrt(deg[g.indices] * deg[dst] + eps)
    return coeff.astype(np.float32)
