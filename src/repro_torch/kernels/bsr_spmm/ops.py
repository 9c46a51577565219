"""Edge-list -> BSR conversion and the wrappers over the CUDA block-sparse
SpMM kernel (``csrc/bsr_spmm.cu``).

On CUDA tensors :func:`bsr_spmm_kernel` (and :func:`bsr_spmm` over it)
checks its inputs, allocates the output with ``torch.empty``, launches the
kernel on the current stream and adds one to :data:`LAUNCHES`; a refused
launch raises. On CPU tensors it runs
:func:`~repro_torch.kernels.bsr_spmm.ref.bsr_spmm_ref` — the only reason it
ever does. There is no fallback from a CUDA tensor to the plain version.

Not carried over from the reference (``src/repro/kernels/bsr_spmm/ops.py``):
``interpret`` (a Pallas mode) and ``d_block`` (a VMEM tile width: the CUDA
kernel picks its own 512-column parts and masks a ragged D, so x is read in
place, never padded or copied); and ``spmm_fallback``, which is
``spmm_edges_ref`` under another name — the port has no fallbacks.

Departures from the TPU kernel, all deliberate: a destination block row
with no nonzero block comes back zero (the TPU kernel leaves it
unwritten); a bfloat16 x is summed across the row's blocks in float32
and rounded once (the TPU kernel rounds after every block); and on the
card only A's nonzero entries are multiplied, so an inf or NaN in x
reaches only the outputs whose row has a nonzero entry against it (the
dense block product, and the plain version, give NaN in every row of a
block whose columns hold it: 0 * inf).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bsr_spmm import ref

# launches since the last reset_launches(); bumped only where the kernel is
# launched (never by the plain version)
LAUNCHES: Dict[str, int] = {"bsr_spmm": 0}

MAX_BLOCK = 128

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_bound = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    """The kernel library with its C signatures set (built on first use)."""
    global _bound
    if _bound is None:
        lib = _build.load("bsr_spmm")
        lib.bsr_spmm_f32.argtypes = [_P, _P, _P, _P, _P, _I64, _I64, _I64,
                                     _I64, _P]
        # bf16 x: a float32 scratch of out's shape after out
        lib.bsr_spmm_bf16x.argtypes = [_P, _P, _P, _P, _P, _P, _I64, _I64,
                                       _I64, _I64, _P]
        for fn in (lib.bsr_spmm_f32, lib.bsr_spmm_bf16x):
            fn.restype = ctypes.c_int
        _bound = lib
    return _bound


def blockify_edges(
    src: np.ndarray, dst: np.ndarray, w: np.ndarray, n_nodes: int,
    block: int = 128,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """COO edges -> BSR ``(a_blocks, row_ids, col_ids, n_blocks)``: the
    nonzero ``block x block`` blocks of ``A[dst, src] += w`` (float32,
    duplicates summed), sorted by destination block row, then column.

    The switching-aware partitioner's vertex reordering makes most edges
    land in few blocks; blocks are sorted by destination row (the kernel
    finds each row's blocks by binary search)."""
    n_blocks = (n_nodes + block - 1) // block
    br = (dst // block).astype(np.int64)
    bc = (src // block).astype(np.int64)
    key = br * n_blocks + bc
    uniq, inv = np.unique(key, return_inverse=True)
    nnz = len(uniq)
    a = np.zeros((nnz, block, block), np.float32)
    np.add.at(a, (inv, dst % block, src % block), w)
    row_ids = (uniq // n_blocks).astype(np.int32)
    col_ids = (uniq % n_blocks).astype(np.int32)
    return a, row_ids, col_ids, n_blocks


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bsr_spmm_kernel(a_blocks: torch.Tensor, row_ids: torch.Tensor,
                    col_ids: torch.Tensor, x: torch.Tensor,
                    n_dst_blocks: int) -> torch.Tensor:
    """``out[r] = sum_{i: row_ids[i] = r} a_blocks[i] @ x[col_ids[i]]``:
    ``a_blocks`` ``(nnz, B, B)`` float32, ``row_ids`` / ``col_ids``
    ``(nnz,)`` int32, ``x`` ``(n_src_blocks, B, D)`` float32 or bfloat16 ->
    ``(n_dst_blocks, B, D)`` in x's dtype, zero in rows with no block.

    ``row_ids`` must be sorted ascending on either device, as
    :func:`blockify_edges` gives them (the kernel finds each row's blocks
    by binary search; ids outside ``[0, n_dst_blocks)`` are never
    reached): unsorted ids raise, a check that waits for the card. On the
    card ``B <= 128`` and ``col_ids`` must lie in ``[0, n_src_blocks)``
    (not checked)."""
    if a_blocks.dim() != 3 or a_blocks.shape[1] != a_blocks.shape[2]:
        raise ValueError(f"a_blocks must be (nnz, B, B), got "
                         f"{tuple(a_blocks.shape)}")
    nnz, B, _ = a_blocks.shape
    if row_ids.shape != (nnz,) or col_ids.shape != (nnz,):
        raise ValueError(
            f"row_ids and col_ids must be ({nnz},); got "
            f"{tuple(row_ids.shape)} and {tuple(col_ids.shape)}")
    if x.dim() != 3 or x.shape[1] != B:
        raise ValueError(f"x must be (n_src_blocks, B={B}, D), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if n_dst_blocks < 0:
        raise ValueError(f"n_dst_blocks={n_dst_blocks} < 0")
    if nnz > 1 and bool((row_ids[1:] < row_ids[:-1]).any()):
        raise ValueError("row_ids must be sorted ascending")
    D = x.shape[2]
    if not x.is_cuda:
        return ref.bsr_spmm_ref(a_blocks, row_ids, col_ids, x, n_dst_blocks)
    dev = x.device
    _check("a_blocks", a_blocks, torch.float32, dev)
    _check("row_ids", row_ids, torch.int32, dev)
    _check("col_ids", col_ids, torch.int32, dev)
    _check("x", x, x.dtype, dev)
    if B > MAX_BLOCK:
        raise ValueError(f"block B={B} > {MAX_BLOCK} is not supported by the "
                         f"kernel")
    if x.shape[0] * B >= 2 ** 31:
        raise ValueError(f"x has {x.shape[0] * B} rows; the kernel addresses "
                         f"them as int32")
    out = torch.empty((n_dst_blocks, B, D), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (a_blocks.data_ptr(), row_ids.data_ptr(), col_ids.data_ptr(),
            x.data_ptr(), out.data_ptr())
    if x.dtype == torch.float32:
        err = _lib().bsr_spmm_f32(*args, nnz, B, D, n_dst_blocks, stream)
    else:
        # the float32 partial sums of rows done in chunks (the kernel keeps
        # them in out itself when out is float32)
        partial = torch.empty(out.shape, dtype=torch.float32, device=dev)
        err = _lib().bsr_spmm_bf16x(*args, partial.data_ptr(), nnz, B, D,
                                    n_dst_blocks, stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmm kernel launch failed: cudaError {err}")
    LAUNCHES["bsr_spmm"] += 1
    return out


def bsr_spmm(x: torch.Tensor, a_blocks: torch.Tensor, row_ids: torch.Tensor,
             col_ids: torch.Tensor, n_dst_blocks: int,
             block: int = 128) -> torch.Tensor:
    """``out[d] = sum_e A[d, s] x[s]`` over the BSR blocks of
    :func:`blockify_edges`: x ``(n, D)`` with ``n >= n_dst_blocks * block``
    (rows past that are not read) -> ``(n_dst_blocks * block, D)`` in x's
    dtype. Source blocks are x's first ``n_dst_blocks`` blocks, as in the
    reference; x is viewed in place, D kept as it is."""
    if x.dim() != 2:
        raise ValueError(f"x must be (n, D), got {tuple(x.shape)}")
    n_pad = n_dst_blocks * block
    D = x.shape[1]
    if x.shape[0] < n_pad:
        raise ValueError(f"x has {x.shape[0]} rows, fewer than n_dst_blocks "
                         f"* block = {n_pad}")
    if a_blocks.dim() != 3 or a_blocks.shape[1] != block:
        raise ValueError(f"a_blocks {tuple(a_blocks.shape)} are not blocks "
                         f"of {block}")
    if x.is_cuda and not x.is_contiguous():
        raise ValueError("x must be contiguous")
    xb = x[:n_pad].reshape(n_dst_blocks, block, D)
    out = bsr_spmm_kernel(a_blocks, row_ids, col_ids, xb, n_dst_blocks)
    return out.view(n_pad, D)
