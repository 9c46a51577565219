"""Plain PyTorch versions of the block-sparse SpMM kernel, and numpy oracles.

:func:`bsr_spmm_ref` is the reference package's ``bsr_spmm_ref``
(``src/repro/kernels/bsr_spmm/ref.py``) in PyTorch: ``out[r] = sum over the
nonzero blocks (r, c) of A_blk @ X[c]``, zero in every destination block
row with no nonzero block. It never materialises ``x[col_ids]`` whole (80 GB
at the GCN main path's 65,536 nodes and D = 1,024): round ``k`` multiplies
the ``k``-th block of every row with ``torch.bmm`` and adds the products to
rows that are unique within the round, so the result has no atomics, the
same bits on every run, and each output element takes its blocks' products
in ascending block order. Products and sums are in float32; a bfloat16 x is
rounded once, at the end, as the CUDA kernel does (the TPU kernel rounds to
x's dtype after every block).

:func:`spmm_edges_ref` is the edge-list form of the same product, through
the port's sorted segment sum. The wrappers in ``ops.py`` run these on CPU
tensors; ``chip_smoke.py`` holds the CUDA kernel against them on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.gather_scatter.ref import gather_aggregate_ref


def _block_rank(row_ids: torch.Tensor) -> torch.Tensor:
    """Each block's rank among the blocks of its row; ``row_ids`` sorted
    ascending, as :func:`~repro_torch.kernels.bsr_spmm.ops.blockify_edges`
    gives them and the wrappers require. int64 ``(nnz,)``."""
    rows = row_ids.long()
    pos = torch.arange(rows.shape[0], device=rows.device)
    return pos - torch.searchsorted(rows, rows)


def bsr_spmm_ref(a_blocks: torch.Tensor, row_ids: torch.Tensor,
                 col_ids: torch.Tensor, x: torch.Tensor,
                 n_dst_blocks: int) -> torch.Tensor:
    """``a_blocks`` ``(nnz, B, B)`` float32, ``row_ids`` (sorted ascending)
    / ``col_ids`` ``(nnz,)``, ``x`` ``(n_src_blocks, B, D)`` float32 or
    bfloat16 -> ``(n_dst_blocks, B, D)`` in x's dtype."""
    nnz, B, _ = a_blocks.shape
    D = x.shape[-1]
    acc = torch.zeros((n_dst_blocks, B, D), dtype=torch.float32,
                      device=x.device)
    if nnz == 0 or D == 0:
        return acc.to(x.dtype)
    rank = _block_rank(row_ids)
    rows = row_ids.long()
    cols = col_ids.long()
    for k in range(int(rank.max()) + 1):
        sel = (rank == k).nonzero()[:, 0]
        r = rows.index_select(0, sel)
        prod = torch.bmm(a_blocks.index_select(0, sel),
                         x.index_select(0, cols.index_select(0, sel)).float())
        acc.index_put_((r,), acc.index_select(0, r) + prod)
    return acc.to(x.dtype)


def bsr_spmm_tolerance(a_blocks: torch.Tensor, row_ids: torch.Tensor,
                       col_ids: torch.Tensor, x: torch.Tensor,
                       n_dst_blocks: int) -> torch.Tensor:
    """Per-element bound on ``|kernel - plain|`` in float32:
    ``(m_r + 1) * 2^-23 / (1 - m_r * 2^-23) * (|A| @ |X|)_r``, ``m_r`` the
    number of nonzero entries of A in the element's row. A zero entry's
    product adds exactly nothing, so each side is a float32 sum of ``m_r``
    rounded terms in some order, within ``gamma_m = m_r * 2^-24 / (1 - m_r
    * 2^-24)`` of the exact sum relative to the sum of magnitudes; the
    plain version on ``|A|``, ``|X|`` gives that magnitude to within
    ``gamma_m`` below, which the denominator covers, and the 1 covers this
    bound's own rounding."""
    mag = bsr_spmm_ref(a_blocks.abs(), row_ids, col_ids, x.float().abs(),
                       n_dst_blocks)
    m = row_nonzeros(a_blocks, row_ids, n_dst_blocks).to(torch.float32)
    m = m[:, :, None]
    return (m + 1) * 2.0 ** -23 / (1 - m * 2.0 ** -23) * mag


def row_nonzeros(a_blocks: torch.Tensor, row_ids: torch.Tensor,
                 n_dst_blocks: int) -> torch.Tensor:
    """The number of nonzero entries of A in each of its rows, int64
    ``(n_dst_blocks, B)`` (exact integer sums, so the same on every run)."""
    m = torch.zeros((n_dst_blocks, a_blocks.shape[1]), dtype=torch.int64,
                    device=a_blocks.device)
    if a_blocks.shape[0]:
        m.index_add_(0, row_ids.long(), (a_blocks != 0).sum(-1))
    return m


def spmm_edges_ref(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                   x: torch.Tensor, n_dst: int) -> torch.Tensor:
    """``out[d] = sum_e w_e * x[src_e]`` over the edges with ``dst_e == d``:
    a stable sort by ``dst``, then the deterministic segment sum of
    :func:`~repro_torch.kernels.gather_scatter.ref.gather_aggregate_ref`
    (edge order within a row, multiply then add)."""
    order = torch.argsort(dst.long(), stable=True)
    return gather_aggregate_ref(x, src.index_select(0, order),
                                dst.index_select(0, order),
                                w.index_select(0, order), n_dst)


def bsr_spmm_np(a_blocks: np.ndarray, row_ids: np.ndarray,
                col_ids: np.ndarray, x: np.ndarray,
                n_dst_blocks: int) -> np.ndarray:
    """Float64 numpy oracle of :func:`bsr_spmm_ref`."""
    a = np.asarray(a_blocks, np.float64)
    xs = np.asarray(x, np.float64)
    out = np.zeros((n_dst_blocks,) + xs.shape[1:])
    if a.shape[0]:
        np.add.at(out, np.asarray(row_ids),
                  np.einsum("nab,nbd->nad", a, xs[np.asarray(col_ids)]))
    return out


def spmm_edges_np(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                  x: np.ndarray, n_dst: int) -> np.ndarray:
    """Float64 numpy oracle of :func:`spmm_edges_ref`."""
    xs = np.asarray(x, np.float64)
    out = np.zeros((n_dst, xs.shape[1]))
    np.add.at(out, np.asarray(dst),
              np.asarray(w, np.float64)[:, None] * xs[np.asarray(src)])
    return out
