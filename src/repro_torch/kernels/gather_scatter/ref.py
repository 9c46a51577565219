"""Plain PyTorch versions of the gather kernels, and the numpy FMA oracle.

The wrappers in ``ops.py`` run these on CPU tensors; ``chip_smoke.py``
holds the CUDA kernels against them on the card. ``gather_aggregate_ref``
multiplies then adds (two roundings per edge), so it may differ from the
kernel's fused multiply-add by ~1 ulp on rows with two or more edges;
:func:`gather_aggregate_ref_fma` reproduces the kernel's arithmetic exactly.
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
