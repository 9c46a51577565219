"""Plain PyTorch versions of the gather/scatter kernels, and numpy oracles.

The wrappers in ``ops.py`` run these on CPU tensors; ``chip_smoke.py``
holds the CUDA kernels against them on the card. ``gather_aggregate_ref``
multiplies then adds (two roundings per edge), so it may differ from the
kernel's fused multiply-add by ~1 ulp on rows with two or more edges;
:func:`gather_aggregate_ref_fma` reproduces the kernel's arithmetic except
at a float64 double rounding (about one step in 2^29), and
:func:`gather_aggregate_fma_np` reproduces it exactly at any size.
``scatter_add_ref`` and the kernel both add in input order, one rounding
per value row, so they are bitwise equal (and equal to
:func:`scatter_add_ref_np`, the ``np.add.at`` oracle).
:func:`segment_sum_ref` sums in the ``segment_sum`` kernel's order, so the
two are bitwise equal on either device.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from repro_torch.models.gnn.layers import seg_sum


def gather_rows_ref(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` — a bitwise row copy."""
    return table.index_select(0, rows)


def gather_aggregate_ref(
    table: torch.Tensor,
    erows: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    n_dst: int,
) -> torch.Tensor:
    """``out[dst[e]] += w[e] * table[erows[e]]`` over zeros: multiply, then
    the deterministic segment sum over ``dst`` (edge order)."""
    msg = table.index_select(0, erows)
    msg.mul_(w.to(table.dtype)[:, None])
    return seg_sum(msg, dst, n_dst)


def gather_aggregate_ref_fma(
    table: np.ndarray,
    erows: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    n_dst: int,
) -> np.ndarray:
    """fp32 oracle for the kernel's FMA accumulation order (the reference
    package's oracle): the f64 product of two fp32 values is exact, and
    product+accumulator summed in f64 and rounded once per edge is the
    fused multiply-add except where that f64 sum lands exactly halfway
    between two float32 values (a double rounding, about one step in 2^29;
    :func:`gather_aggregate_fma_np` resolves those exactly). Python loop —
    test-sized inputs only."""
    table = np.asarray(table)
    out = np.zeros((n_dst, table.shape[1]), table.dtype)
    w = np.asarray(w)
    for e in range(np.asarray(erows).size):
        prod = np.float64(w[e]) * table[erows[e]].astype(np.float64)
        out[dst[e]] = (
            out[dst[e]].astype(np.float64) + prod
        ).astype(table.dtype)
    return out


def fma32_exact(a, b, c) -> np.float32:
    """``a * b + c`` rounded once to float32, ties to even (the card's
    ``__fmaf_rn``), in exact rational arithmetic. Finite inputs only."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(x))       # within one float32 step of the answer
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.float32(v).view(np.uint32)) & 1))


def gather_aggregate_fma_np(
    table: np.ndarray,
    erows: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray,
    n_dst: int,
    threads: int = 1,
):
    """Bit-exact numpy oracle of the kernel's arithmetic: each output
    element is ``acc = fma(w[e], table[erows[e], c], acc)`` from zero over
    its row's edges in edge order, one float32 rounding per edge.

    Each step adds the exact float64 product to the float32 accumulator in
    float64 and rounds to float32, as :func:`gather_aggregate_ref_fma`
    does. That rounds twice only where the float64 sum ``s`` lies exactly
    halfway between two float32 values (its 29 low fraction bits
    ``1000...0``; elsewhere a float32 midpoint between the exact sum and
    ``s`` would be a float64 nearer the exact sum than ``s``). There the
    sum's float64 rounding error (Knuth's two-sum) says which way the
    exact sum lies, and the step rounds that way. Exact while every partial
    sum is zero or in float32's normal range (ties among float32
    subnormals are not looked for).

    Vectorised over the rows by edge position (rows by in-degree, so the
    active rows are a prefix), in ``threads`` threads over interleaved row
    groups, with preallocated buffers: main-path sizes take seconds.
    Returns ``(out, double_roundings)``: the ``(n_dst, D)`` float32 result
    and the number of steps where the float64 route would have rounded
    twice."""
    from concurrent.futures import ThreadPoolExecutor

    table = np.asarray(table, np.float64)
    erows, dst = np.asarray(erows), np.asarray(dst)
    w = np.asarray(w, np.float32).astype(np.float64)
    D = table.shape[1]
    out = np.zeros((n_dst, D), np.float32)
    order = np.argsort(dst, kind="stable")     # each row's edges in order
    rows, counts = np.unique(dst, return_counts=True)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    by_deg = np.argsort(-counts, kind="stable")

    def run(group):
        cnt, at = counts[group], first[group]
        acc = np.zeros((group.size, D), np.float32)
        x, s = np.empty((2, group.size, D))
        low = np.empty((group.size, D), np.int64)
        tie = np.empty((group.size, D), bool)
        twice = 0
        for k in range(int(cnt[0]) if group.size else 0):
            n = int(np.searchsorted(-cnt, -k, "left"))  # rows with > k edges
            e = order[at[:n] + k]
            xs, ss, a = x[:n], s[:n], acc[:n]
            np.take(table, erows[e], axis=0, out=xs)
            np.multiply(w[e][:, None], xs, out=xs)      # exact products
            np.add(a, xs, out=ss)
            np.bitwise_and(ss.view(np.int64), 0x1FFFFFFF, out=low[:n])
            np.equal(low[:n], 0x10000000, out=tie[:n])
            at_tie = np.nonzero(tie[:n]) if tie[:n].any() else None
            if at_tie is not None:
                av, pv, sv = a[at_tie].astype(np.float64), xs[at_tie], ss[at_tie]
                bp = sv - av
                err = (av - (sv - bp)) + (pv - bp)
            np.copyto(a, ss, casting="same_kind")       # round to float32
            if at_tie is not None:
                r = a[at_tie]
                up = (err > 0) & (r < sv)
                down = (err < 0) & (r > sv)
                r[up] = np.nextafter(r[up], np.float32(np.inf))
                r[down] = np.nextafter(r[down], np.float32(-np.inf))
                a[at_tie] = r
                twice += int(up.sum() + down.sum())
        out[rows[group]] = acc
        return twice

    groups = [by_deg[t::threads] for t in range(max(threads, 1))]
    with ThreadPoolExecutor(len(groups)) as ex:
        twice = sum(ex.map(run, groups))
    return out, twice


def scatter_add_ref(base: torch.Tensor, rows: torch.Tensor,
                    values: torch.Tensor) -> torch.Tensor:
    """``base[rows[i]] += values[i]`` in place, in input order (one add per
    value row); returns ``base``. ``rows`` sorted ascending, so duplicates
    meet in one run.

    Round ``k`` adds every run's ``k``-th value row to its row with a plain
    gather-add-put over indices that are unique within the round, so each
    row sees its values one at a time in input order — ``np.add.at``'s
    order on either device, with no atomics (``index_add_`` uses float
    atomics on a CUDA tensor, and the CUDA ``index_put_(accumulate=True)``
    does not add duplicates one by one from the stored value at widths
    below 32 columns). One round when the rows are unique, as the engine's
    are."""
    n = rows.shape[0]
    if n == 0:
        return base
    rows = rows.long()
    pos = torch.arange(n, device=rows.device)
    starts = torch.ones(n, dtype=torch.bool, device=rows.device)
    starts[1:] = rows[1:] != rows[:-1]
    # each value row's rank inside its run of equal rows
    rank = pos - torch.cummax(torch.where(starts, pos, 0), 0).values
    for k in range(int(rank.max()) + 1):
        sel = (rank == k).nonzero()[:, 0]
        r = rows.index_select(0, sel)
        base.index_put_((r,), base.index_select(0, r)
                        + values.index_select(0, sel))
    return base


def scatter_add_ref_np(base: np.ndarray, rows: np.ndarray,
                       values: np.ndarray) -> np.ndarray:
    """Numpy oracle: ``out = base; out[rows] += values`` with ``np.add.at``
    (sequential, input order); a new array."""
    out = np.array(base)
    if rows.size:
        np.add.at(out, np.asarray(rows), np.asarray(values, dtype=out.dtype))
    return out


def _add_rows(base: torch.Tensor, rows: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """``base[rows[i]] += values[i]`` one value row at a time in input order
    (``rows`` sorted ascending): the CPU's sequential ``index_add_``, on the
    card :func:`scatter_add_ref`'s rounds (no atomics)."""
    if base.is_cuda:
        return scatter_add_ref(base, rows, values)
    return base.index_add_(0, rows, values)


def segment_sum_ref(x: torch.Tensor, seg: torch.Tensor, n: int,
                    chunk: int) -> torch.Tensor:
    """Plain version of the ``segment_sum`` kernel: ``out[seg[i]] += x[i]``
    over zeros, ``out`` ``(n,) + x.shape[1:]``, in the kernel's order. The
    ids are stable-sorted, so each segment's edges lie in edge order (an id
    outside ``[0, n)`` falls in no segment); each segment is cut into
    chunks of ``chunk`` consecutive edges from its start; each chunk sums
    its edges in edge order from +0, and each segment its chunk sums in
    chunk order from +0. A segment of at most ``chunk`` edges is therefore
    its edges' sum in edge order: a sequential ``np.add.at``."""
    keys, perm = torch.sort(seg, stable=True)
    keep = (keys >= 0) & (keys < n)
    keys, perm = keys[keep].long(), perm[keep]
    trailing = tuple(x.shape[1:])
    out = x.new_zeros((n,) + trailing)
    if keys.numel() == 0:
        return out
    pos = torch.arange(keys.numel(), device=keys.device)
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    seg_start = torch.cummax(torch.where(first, pos, 0), 0).values
    opens = (pos - seg_start) % chunk == 0      # each chunk's first edge
    cid = torch.cumsum(opens, 0) - 1
    sums = _add_rows(x.new_zeros((int(cid[-1]) + 1,) + trailing), cid,
                     x.index_select(0, perm))
    return _add_rows(out, keys[opens], sums)
