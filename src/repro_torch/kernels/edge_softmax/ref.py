"""Plain PyTorch version of the edge-softmax kernel, its backward, and a
numpy oracle.

:func:`edge_softmax_ref` is the reference package's ``edge_softmax_ref``
(``src/repro/kernels/edge_softmax/ref.py``) in PyTorch: the per-destination
segment max floored at ``-1e30``, ``exp``, the deterministic
:func:`~repro_torch.models.gnn.layers.seg_sum`, and a division by the sum
clamped at ``1e-30``. The wrapper in ``ops.py`` runs it on CPU tensors;
``chip_smoke.py`` holds the CUDA kernel against it on the card. The kernel
sums each segment in its own (warp) order, so the two agree to within the
rounding of a ``deg``-term sum, not bitwise.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.gnn.layers import seg_max, seg_sum


def edge_softmax_ref(scores: torch.Tensor, dst: torch.Tensor,
                     n_dst: int) -> torch.Tensor:
    """``scores`` ``(E, H)``, ``dst`` ``(E,)`` -> ``attn`` ``(E, H)``
    normalised per destination segment."""
    smax = torch.maximum(seg_max(scores, dst, n_dst),
                         scores.new_full((), -1e30))
    ex = torch.exp(scores - smax.index_select(0, dst))
    den = seg_sum(ex, dst, n_dst)
    return ex / torch.maximum(den.index_select(0, dst),
                              ex.new_full((), 1e-30))


def edge_softmax_backward_ref(attn: torch.Tensor, d_attn: torch.Tensor,
                              dst: torch.Tensor, n_dst: int) -> torch.Tensor:
    """``dS = A * (dA - seg_sum(A * dA, dst)[dst])``: the softmax's vjp per
    destination segment, with the deterministic segment sum."""
    t = seg_sum(attn * d_attn, dst, n_dst)
    return attn * (d_attn - t.index_select(0, dst))


def edge_softmax_np(scores: np.ndarray, dst: np.ndarray,
                    n_dst: int) -> np.ndarray:
    """Float64 numpy oracle of the same function: the max, the
    exponentials and the sums in double precision."""
    s = np.asarray(scores, np.float64)
    dst = np.asarray(dst)
    smax = np.full((n_dst, s.shape[1]), -np.inf)
    np.maximum.at(smax, dst, s)
    smax = np.maximum(smax, -1e30)
    ex = np.exp(s - smax[dst])
    den = np.zeros((n_dst, s.shape[1]))
    np.add.at(den, dst, ex)
    return ex / np.maximum(den[dst], 1e-30)
