"""Switching-aware partitioning (paper §6, Appendix I).

Label-propagation partitioner whose working set is only the CSR arrays plus one
int16/int32 "Dst's Partition" array aligned with ``indices`` — O(2|V| + 2|E|)
memory vs METIS' multi-stage intermediates. Vertices iteratively relocate to the
partition holding most of their neighbors, subject to a size penalty
(``alpha_balance``) and per-iteration relocation capacity (``beta``); relocation
candidates are selected group-wise by their 2nd-preference partition to keep
clusters together (Appendix I, Figure 19).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class PartitionResult:
    parts: np.ndarray           # int32 (n_nodes,) partition id per vertex
    n_parts: int
    objective_history: List[float]
    alpha_history: List[float]
    iterations: int
    seconds: float
    # Table-4 style memory accounting (bytes)
    graph_bytes: int
    label_bytes: int
    additional_bytes: int

    @property
    def total_bytes(self) -> int:
        return self.graph_bytes + self.label_bytes + self.additional_bytes


def random_partition(n_nodes: int, n_parts: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_parts, n_nodes).astype(np.int32)


def _blocked_scores(
    g: CSRGraph,
    parts: np.ndarray,
    dst_part: np.ndarray,
    penalty: np.ndarray,
    n_parts: int,
    block: int,
):
    """Yield per-block (v_ids, best_j, second_j, gain, cur_score_sum)."""
    n = g.n_nodes
    for v0 in range(0, n, block):
        v1 = min(v0 + block, n)
        e0, e1 = g.indptr[v0], g.indptr[v1]
        deg = np.diff(g.indptr[v0 : v1 + 1]).astype(np.int64)
        bs = v1 - v0
        # neighbor-partition frequency matrix F: (bs, p)
        row = np.repeat(np.arange(bs, dtype=np.int64), deg)
        flat = row * n_parts + dst_part[e0:e1]
        F = np.bincount(flat, minlength=bs * n_parts).reshape(bs, n_parts)
        degf = np.maximum(deg, 1).astype(np.float64)[:, None]
        score = 1.0 + F / degf - penalty[None, :]
        cur = parts[v0:v1]
        cur_score = score[np.arange(bs), cur]
        best_j = np.argmax(score, axis=1).astype(np.int32)
        best_s = score[np.arange(bs), best_j]
        # 2nd preference by neighbor frequency (for group-wise selection)
        F2 = F.copy()
        F2[np.arange(bs), np.argmax(F, axis=1)] = -1
        second_j = np.argmax(F2, axis=1).astype(np.int32)
        gain = best_s - cur_score
        yield v0, best_j, second_j, gain, float(cur_score.sum()), deg


def switching_aware_partition(
    g: CSRGraph,
    n_parts: int,
    max_iters: int = 50,
    alpha_balance: float = 1.1,
    beta: float = 1.1,
    eps: float = 1e-3,
    patience: int = 5,
    seed: int = 0,
    block: int = 1 << 16,
    init_parts: Optional[np.ndarray] = None,
    track_alpha: bool = False,
) -> PartitionResult:
    t0 = time.perf_counter()
    n = g.n_nodes
    parts = (
        init_parts.astype(np.int32).copy()
        if init_parts is not None
        else random_partition(n, n_parts, seed)
    )
    dst_part = parts[g.indices]  # the "Dst's Partition" array (paper Fig 7b)
    target = n / n_parts
    obj_hist: List[float] = []
    alpha_hist: List[float] = []
    stall = 0
    for it in range(max_iters):
        sizes = np.bincount(parts, minlength=n_parts).astype(np.float64)
        penalty = sizes / (alpha_balance * target)
        cap = np.maximum(beta * target - sizes, 0.0).astype(np.int64)

        cand_v, cand_tgt, cand_2nd, cand_gain = [], [], [], []
        obj = 0.0
        for v0, best_j, second_j, gain, cur_sum, deg in _blocked_scores(
            g, parts, dst_part, penalty, n_parts, block
        ):
            obj += cur_sum
            bs = best_j.shape[0]
            cur = parts[v0 : v0 + bs]
            mask = (best_j != cur) & (gain > 0) & (deg > 0)
            idx = np.nonzero(mask)[0]
            if idx.size:
                cand_v.append((v0 + idx).astype(np.int64))
                cand_tgt.append(best_j[idx])
                cand_2nd.append(second_j[idx])
                cand_gain.append(gain[idx])
        obj_hist.append(obj)
        if track_alpha:
            alpha_hist.append(expansion_ratio(g, parts, n_parts))

        if not cand_v:
            break
        v = np.concatenate(cand_v)
        tgt = np.concatenate(cand_tgt)
        snd = np.concatenate(cand_2nd)

        # Group-wise relocation: within each target partition, order candidate
        # groups by the size of their shared 2nd-preference cluster (largest
        # group first), then admit up to the relocation capacity RC_j.
        group_key = tgt.astype(np.int64) * n_parts + snd.astype(np.int64)
        uniq, inv, counts = np.unique(
            group_key, return_inverse=True, return_counts=True
        )
        group_size = counts[inv]
        # sort candidates by (target, -group_size) then enumerate ranks per tgt
        order = np.lexsort((-group_size, tgt))
        v_o, tgt_o = v[order], tgt[order]
        # rank within each target partition
        start = np.zeros(len(tgt_o), dtype=np.int64)
        new_grp = np.empty(len(tgt_o), dtype=bool)
        new_grp[0] = True
        new_grp[1:] = tgt_o[1:] != tgt_o[:-1]
        seg_starts = np.nonzero(new_grp)[0]
        rank = np.arange(len(tgt_o)) - np.repeat(
            seg_starts, np.diff(np.append(seg_starts, len(tgt_o)))
        )
        admit = rank < cap[tgt_o]
        moved_v = v_o[admit]
        moved_tgt = tgt_o[admit]
        if moved_v.size == 0:
            stall += 1
            if stall >= patience:
                break
            continue
        parts[moved_v] = moved_tgt
        # destination-level update of the Dst's Partition array
        dst_part = parts[g.indices]

        if len(obj_hist) >= 2:
            prev = obj_hist[-2]
            rel = abs(obj_hist[-1] - prev) / (abs(prev) + 1e-12)
            stall = stall + 1 if rel < eps else 0
            if stall >= patience:
                break

    return PartitionResult(
        parts=parts,
        n_parts=n_parts,
        objective_history=obj_hist,
        alpha_history=alpha_hist,
        iterations=len(obj_hist),
        seconds=time.perf_counter() - t0,
        graph_bytes=g.nbytes(),
        label_bytes=parts.nbytes,
        additional_bytes=dst_part.nbytes,
    )


def spinner_like_partition(
    g: CSRGraph,
    n_parts: int,
    max_iters: int = 50,
    alpha_balance: float = 1.1,
    move_prob: float = 0.5,
    seed: int = 0,
    block: int = 1 << 16,
    track_alpha: bool = False,
) -> PartitionResult:
    """Spinner-style baseline: probabilistic label propagation, no group-wise
    selection and no hard relocation capacity (Martella et al. 2017)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    n = g.n_nodes
    parts = random_partition(n, n_parts, seed)
    dst_part = parts[g.indices]
    target = n / n_parts
    obj_hist: List[float] = []
    alpha_hist: List[float] = []
    for it in range(max_iters):
        sizes = np.bincount(parts, minlength=n_parts).astype(np.float64)
        penalty = sizes / (alpha_balance * target)
        obj = 0.0
        moves_v, moves_t = [], []
        for v0, best_j, second_j, gain, cur_sum, deg in _blocked_scores(
            g, parts, dst_part, penalty, n_parts, block
        ):
            obj += cur_sum
            bs = best_j.shape[0]
            cur = parts[v0 : v0 + bs]
            mask = (best_j != cur) & (gain > 0) & (deg > 0)
            mask &= rng.random(bs) < move_prob
            idx = np.nonzero(mask)[0]
            if idx.size:
                moves_v.append((v0 + idx).astype(np.int64))
                moves_t.append(best_j[idx])
        obj_hist.append(obj)
        if track_alpha:
            alpha_hist.append(expansion_ratio(g, parts, n_parts))
        if not moves_v:
            break
        parts[np.concatenate(moves_v)] = np.concatenate(moves_t)
        dst_part = parts[g.indices]
    return PartitionResult(
        parts=parts,
        n_parts=n_parts,
        objective_history=obj_hist,
        alpha_history=alpha_hist,
        iterations=len(obj_hist),
        seconds=time.perf_counter() - t0,
        graph_bytes=g.nbytes(),
        label_bytes=parts.nbytes,
        additional_bytes=dst_part.nbytes,
    )


def expansion_ratio(g: CSRGraph, parts: np.ndarray, n_parts: int) -> float:
    """alpha = mean over partitions of (#required vertices / #target vertices).

    Required = union of (partition's own vertices, sources of its in-edges).
    """
    n = g.n_nodes
    dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
    dst_p = parts[dst].astype(np.int64)
    key = dst_p * n + g.indices.astype(np.int64)
    own_key = parts.astype(np.int64) * n + np.arange(n, dtype=np.int64)
    key = np.unique(np.concatenate([key, own_key]))
    required = np.bincount(key // n, minlength=n_parts).astype(np.float64)
    target = np.bincount(parts, minlength=n_parts).astype(np.float64)
    mask = target > 0
    return float((required[mask] / target[mask]).mean())


def partition_dependency_matrix(
    g: CSRGraph, parts: np.ndarray, n_parts: int
) -> np.ndarray:
    """M[j, k] = #unique vertices of partition k required by partition j
    (paper Fig 5a / Appendix E power-law profile)."""
    n = g.n_nodes
    dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(g.indptr))
    dst_p = parts[dst].astype(np.int64)
    key = np.unique(dst_p * n + g.indices.astype(np.int64))
    req_vertex = key % n
    req_dstp = key // n
    flat = req_dstp * n_parts + parts[req_vertex].astype(np.int64)
    M = np.bincount(flat, minlength=n_parts * n_parts)
    return M.reshape(n_parts, n_parts)


def partition_balance(parts: np.ndarray, n_parts: int) -> float:
    """max partition size / mean partition size."""
    sizes = np.bincount(parts, minlength=n_parts).astype(np.float64)
    return float(sizes.max() / max(sizes.mean(), 1e-9))
