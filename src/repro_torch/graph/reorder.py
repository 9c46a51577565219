"""Partition-contiguous vertex reordering (paper Appendix G.2).

After partitioning, vertices are renumbered so each partition occupies a
contiguous id range, and each adjacency list is sorted by (partition, vertex)
of the neighbor — turning the host-side gather into one sequential run per
source partition instead of per-vertex random lookups.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class ReorderedGraph:
    graph: CSRGraph              # renumbered, adjacency sorted by (part, vid)
    parts: np.ndarray            # int32 (n,) partition id (non-decreasing)
    part_ptr: np.ndarray         # int64 (p+1,) vertex range per partition
    perm: np.ndarray             # new_id -> old_id
    inv_perm: np.ndarray         # old_id -> new_id
    n_parts: int

    def partition_slice(self, p: int) -> Tuple[int, int]:
        return int(self.part_ptr[p]), int(self.part_ptr[p + 1])


def reorder_by_partition(
    g: CSRGraph, parts: np.ndarray, n_parts: int
) -> ReorderedGraph:
    n = g.n_nodes
    # stable sort vertices by partition -> perm
    perm = np.argsort(parts, kind="stable").astype(np.int64)  # new -> old
    inv_perm = np.empty(n, dtype=np.int64)
    inv_perm[perm] = np.arange(n)
    new_parts = parts[perm].astype(np.int32)
    part_ptr = np.zeros(n_parts + 1, dtype=np.int64)
    np.add.at(part_ptr, new_parts + 1, 1)
    np.cumsum(part_ptr, out=part_ptr)

    # rebuild CSR under the renumbering
    old_dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
    new_src = inv_perm[g.indices]
    new_dst = inv_perm[old_dst]
    # sort edges by (new_dst, part[new_src], new_src): dst-major CSR with
    # in-partition neighbor ordering
    src_part = new_parts[new_src].astype(np.int64)
    order = np.lexsort((new_src, src_part, new_dst))
    new_src = new_src[order].astype(np.int32)
    new_dst = new_dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, new_dst + 1, 1)
    np.cumsum(indptr, out=indptr)
    rg = CSRGraph(indptr=indptr, indices=new_src, n_nodes=n)
    return ReorderedGraph(
        graph=rg,
        parts=new_parts,
        part_ptr=part_ptr,
        perm=perm,
        inv_perm=inv_perm,
        n_parts=n_parts,
    )
