"""Plain PyTorch versions of the gather/scatter kernels, and numpy oracles.

The wrappers in ``ops.py`` run these on CPU tensors; ``chip_smoke.py``
holds the CUDA kernels against them on the card. ``gather_aggregate_ref``
multiplies then adds (two roundings per edge), so it may differ from the
kernel's fused multiply-add by ~1 ulp on rows with two or more edges;
:func:`gather_aggregate_ref_fma` reproduces the kernel's arithmetic exactly.
``scatter_add_ref`` and the kernel both add in input order, one rounding
per value row, so they are bitwise equal (and equal to
:func:`scatter_add_ref_np`, the ``np.add.at`` oracle).
"""
from __future__ import annotations

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
    """Bit-exact fp32 oracle for the kernel's FMA accumulation order: the
    f64 product of two fp32 values is exact, so product+accumulator summed
    in f64 and rounded once per edge IS the fused multiply-add. Python loop
    — test-sized inputs only."""
    table = np.asarray(table)
    out = np.zeros((n_dst, table.shape[1]), table.dtype)
    w = np.asarray(w)
    for e in range(np.asarray(erows).size):
        prod = np.float64(w[e]) * table[erows[e]].astype(np.float64)
        out[dst[e]] = (
            out[dst[e]].astype(np.float64) + prod
        ).astype(table.dtype)
    return out


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
