"""Static partition-wise execution plan (paper Algorithm 1 preprocessing).

Built once per (graph, partitioning): per-partition work units with the
gathered-source index structure, partition-boundary pointers into the sorted
requirement set (so the host gather is one sequential run per source
partition — Appendix G.2), and pow2-bucket padding so the per-partition jitted
step functions see a handful of shapes instead of P×L.

Port note: identical plan to the reference; only the padded per-unit
topology lives as torch tensors on the plan's device (everything else stays
numpy, host-side).

The schedule greedily orders partitions to maximize consecutive overlap of
required source partitions (paper Appendix G.1 step ①: "pick the next target
partition to exploit already-cached neighbors").
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.reorder import ReorderedGraph, reorder_by_partition
from repro_torch.models.gnn.layers import LocalTopo


def _next_pow2(x: int, floor: int = 8) -> int:
    return max(floor, 1 << int(np.ceil(np.log2(max(x, 1)))))


def remap_edge_weight(
    g: CSRGraph, ro: ReorderedGraph, edge_weight: np.ndarray
) -> np.ndarray:
    """Per-edge weights from the original CSR edge order to the reordered
    graph's CSR edge order (same (src, dst) pairs, new positions)."""
    n = g.n_nodes
    old_dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
    key_old = old_dst * n + g.indices.astype(np.int64)
    order = np.argsort(key_old, kind="stable")
    key_sorted = key_old[order]
    w_sorted = np.asarray(edge_weight)[order]
    rg = ro.graph
    new_dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(rg.indptr))
    key_new = ro.perm[new_dst] * n + ro.perm[rg.indices.astype(np.int64)]
    pos = np.searchsorted(key_sorted, key_new)
    # searchsorted only returns an insertion point: a reordered edge with no
    # counterpart in the original graph would silently pick up a neighbor's
    # weight, so verify every looked-up key actually matches
    if key_new.size:
        if key_sorted.size == 0:
            raise ValueError(
                "remap_edge_weight: original graph has no edges but the "
                f"reordered graph has {key_new.size}"
            )
        safe = np.minimum(pos, key_sorted.size - 1)
        bad = (pos >= key_sorted.size) | (key_sorted[safe] != key_new)
        if bad.any():
            raise ValueError(
                "remap_edge_weight: reordered graph contains edges absent "
                f"from the original graph ({int(bad.sum())} unmatched of "
                f"{key_new.size})"
            )
    return w_sorted[pos].astype(np.float32)


@dataclasses.dataclass
class WorkUnit:
    p: int
    v0: int
    v1: int
    n_dst: int
    n_req: int
    n_edges: int
    r_pad: int                  # padded GA rows (pow2 bucket)
    d_pad: int                  # padded dst rows
    e_pad: int                  # padded edges
    req_global: np.ndarray      # int64 (n_req,) sorted; includes own vertices
    req_part_ptr: np.ndarray    # int64 (P+1,) run boundaries per src partition
    req_parts: np.ndarray       # int32 partitions with nonzero requirement
    topo: LocalTopo             # padded topology, tensors on the plan's device

    def device_bytes(self, d_in: int, d_out: int, itemsize: int = 4) -> int:
        return (
            self.d_pad * d_out * itemsize
            + self.r_pad * d_in * itemsize
            + self.e_pad * 16
        )


@dataclasses.dataclass
class PartitionPlan:
    ro: ReorderedGraph
    units: List[WorkUnit]
    schedule: List[int]
    n_parts: int
    n_nodes: int
    alpha: float                 # mean expansion ratio of the plan
    edge_weight: Optional[np.ndarray]
    device: torch.device = torch.device("cpu")

    def unit(self, p: int) -> WorkUnit:
        return self.units[p]

    def lookahead(self, i: int, depth: int) -> List[WorkUnit]:
        """Work units at schedule positions ``i+1 .. i+depth`` — what the
        pipeline prefetcher should be staging while position ``i`` computes."""
        if depth <= 0:
            return []
        return [self.units[p] for p in self.schedule[i + 1 : i + 1 + depth]]

    def upcoming_parts(self, i: int, depth: int) -> np.ndarray:
        """Sorted union of source partitions required by the next ``depth``
        scheduled units after position ``i`` — the prefetch working set a
        depth-``depth`` pipeline keeps resident (reported by
        benchmarks/pipeline_overlap.py for sizing cache budgets)."""
        parts: set = set()
        for u in self.lookahead(i, depth):
            parts.update(int(q) for q in u.req_parts)
        return np.array(sorted(parts), np.int32)


def build_plan(
    g: CSRGraph,
    parts: np.ndarray,
    n_parts: int,
    edge_weight: Optional[np.ndarray] = None,
    pad_pow2: bool = True,
    device: DeviceLike = None,
) -> PartitionPlan:
    """``edge_weight`` is per-edge in the ORIGINAL graph's CSR edge order.
    The units' topologies are placed on ``device`` (the CUDA card unless
    ``device="cpu"`` is passed)."""
    device = resolve_device(device)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    ro = reorder_by_partition(g, parts, n_parts)
    rg = ro.graph
    n = rg.n_nodes
    ew_new = (
        remap_edge_weight(g, ro, edge_weight)
        if edge_weight is not None else None
    )

    units: List[WorkUnit] = []
    alphas = []
    for p in range(n_parts):
        v0, v1 = ro.partition_slice(p)
        n_dst = v1 - v0
        e0, e1 = int(rg.indptr[v0]), int(rg.indptr[v1])
        srcs = rg.indices[e0:e1].astype(np.int64)
        deg = np.diff(rg.indptr[v0 : v1 + 1]).astype(np.int64)
        dst_local = np.repeat(np.arange(n_dst, dtype=np.int64), deg)
        req = np.union1d(np.unique(srcs), np.arange(v0, v1, dtype=np.int64))
        src_local = np.searchsorted(req, srcs)
        dst_self = np.searchsorted(req, np.arange(v0, v1, dtype=np.int64))
        req_part_ptr = np.searchsorted(req, ro.part_ptr).astype(np.int64)
        req_counts = np.diff(req_part_ptr)
        req_parts = np.nonzero(req_counts)[0].astype(np.int32)
        ew = (
            ew_new[e0:e1]
            if ew_new is not None
            else np.ones(e1 - e0, np.float32)
        )
        n_edges = e1 - e0
        n_req = req.shape[0]
        alphas.append(n_req / max(n_dst, 1))

        if pad_pow2:
            e_pad = _next_pow2(n_edges)
            r_pad = _next_pow2(n_req)
            d_pad = _next_pow2(n_dst)
        else:
            e_pad, r_pad, d_pad = n_edges, n_req, n_dst

        src_p = np.zeros(e_pad, np.int32)
        src_p[:n_edges] = src_local
        dst_p = np.zeros(e_pad, np.int32)
        dst_p[:n_edges] = dst_local
        ew_p = np.zeros(e_pad, np.float32)
        ew_p[:n_edges] = ew
        mask_p = np.zeros(e_pad, np.float32)
        mask_p[:n_edges] = 1.0
        indeg_p = np.ones(d_pad, np.float32)
        indeg_p[:n_dst] = np.maximum(deg, 1)
        self_p = np.zeros(d_pad, np.int32)
        self_p[:n_dst] = dst_self

        topo = LocalTopo(
            src=dev(src_p),
            dst=dev(dst_p),
            n_dst=d_pad,
            edge_weight=dev(ew_p),
            edge_mask=dev(mask_p),
            in_deg=dev(indeg_p),
            dst_self=dev(self_p),
            n_real_edges=n_edges,
        )
        units.append(
            WorkUnit(
                p=p, v0=v0, v1=v1, n_dst=n_dst, n_req=n_req, n_edges=n_edges,
                r_pad=r_pad, d_pad=d_pad, e_pad=e_pad,
                req_global=req, req_part_ptr=req_part_ptr, req_parts=req_parts,
                topo=topo,
            )
        )

    schedule = _greedy_schedule(units, n_parts)
    return PartitionPlan(
        ro=ro,
        units=units,
        schedule=schedule,
        n_parts=n_parts,
        n_nodes=n,
        alpha=float(np.mean(alphas)),
        edge_weight=ew_new,
        device=device,
    )


def _greedy_schedule(units: List[WorkUnit], n_parts: int) -> List[int]:
    if n_parts <= 2:
        return list(range(n_parts))
    sets = [set(u.req_parts.tolist()) for u in units]
    visited = [False] * n_parts
    order = [0]
    visited[0] = True
    for _ in range(n_parts - 1):
        cur = sets[order[-1]]
        best, best_ov = -1, -1
        for q in range(n_parts):
            if visited[q]:
                continue
            ov = len(cur & sets[q])
            if ov > best_ov:
                best, best_ov = q, ov
        order.append(best)
        visited[best] = True
    return order
