"""Wrapper over the CUDA edge-softmax kernel (``csrc/edge_softmax.cu``) and
its ``torch.autograd.Function``.

On a CUDA tensor :func:`edge_softmax` checks its inputs, allocates the
output with ``torch.empty``, launches the kernel on the calling thread's
current stream and adds one to :data:`LAUNCHES`; a refused launch raises.
On a CPU tensor it runs the plain version in ``ref.py`` — the only reason it
ever does. There is no fallback from a CUDA tensor to the plain version.

The reference wrapper packed the edges into 128-row destination blocks of a
padded tile (``pack_edges_by_block``, a TPU layout); this one takes the
edges as they are, sorted by destination, as a plan's real-edge prefix is.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.edge_softmax import ref
from repro_torch.kernels.heavy_rows import heavy_slots, plan_scratch

# launches since the last reset_launches(); bumped only where the kernel is
# launched (never by the plain version)
LAUNCHES: Dict[str, int] = {"edge_softmax": 0}

# a row with more edges is a heavy row and takes a whole block (chosen on
# the H100: scripts/pt_heavy_rows.py)
HEAVY_EDGES = 512

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_bound = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    """The kernel library with its C signature set (built on first use)."""
    global _bound
    if _bound is None:
        lib = _build.load("edge_softmax")
        lib.edge_softmax_f32.argtypes = [
            _P, _P, _P, _I64, _I64, _I64, _P, _P, _I64, _I64, _P,
        ]
        lib.edge_softmax_f32.restype = ctypes.c_int
        _bound = lib
    return _bound


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def edge_softmax(scores: torch.Tensor, dst: torch.Tensor,
                 n_dst: int) -> torch.Tensor:
    """``attn[e, h] = exp(s[e, h] - m[dst[e], h]) / den[dst[e], h]``: the
    softmax of ``scores`` ``(E, H)`` float32 over each destination's edges
    (``m`` the segment max floored at ``-1e30``, ``den`` the segment sum of
    the exponentials clamped at ``1e-30``).

    ``dst`` ``(E,)`` int32 must be sorted ascending with values in
    ``[0, n_dst)``: the kernel takes each row's edges from the row plan its
    launch makes first on the device (``kernels/csrc/heavy_rows.cuh``,
    whose plain version is :func:`~repro_torch.kernels.heavy_rows.
    plan_rows`; no host synchronisation) into scratch allocated here, and
    an edge outside every row's range would be left unwritten.

    On the card a thread takes an edge's heads together (up to 8 a launch),
    three passes over a row's edges in all (max, sum, write). A row with
    more than :data:`HEAVY_EDGES` (512) edges takes a whole 512-thread
    block (persistent blocks walk the heavy list, those with more than 16
    times as many edges first); every other row one warp, in row order."""
    if scores.dim() != 2 or dst.dim() != 1:
        raise ValueError(
            f"edge_softmax wants scores (E, H) and dst (E,); got "
            f"{tuple(scores.shape)} and {tuple(dst.shape)}"
        )
    E, H = scores.shape
    if dst.shape[0] != E:
        raise ValueError(f"scores has {E} edges, dst {dst.shape[0]}")
    if E == 0 or H == 0:
        return scores.new_zeros((E, H))
    if n_dst <= 0:
        raise ValueError(f"{E} edges into n_dst={n_dst} rows")
    if not scores.is_cuda:
        return ref.edge_softmax_ref(scores, dst, n_dst)
    dev = scores.device
    _check("scores", scores, torch.float32, dev)
    _check("dst", dst, torch.int32, dev)
    out = torch.empty_like(scores)
    starts, heavy = plan_scratch(E, n_dst, HEAVY_EDGES, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().edge_softmax_f32(
        scores.data_ptr(), dst.data_ptr(), out.data_ptr(), E, n_dst, H,
        starts.data_ptr(), heavy.data_ptr(),
        heavy_slots(E, n_dst, HEAVY_EDGES), HEAVY_EDGES,
        stream,
    )
    if err != 0:
        raise RuntimeError(f"edge_softmax kernel launch failed: cudaError {err}")
    LAUNCHES["edge_softmax"] += 1
    return out


class EdgeSoftmax(torch.autograd.Function):
    """:func:`edge_softmax` (the kernel on a CUDA tensor) with the plain,
    deterministic backward :func:`ref.edge_softmax_backward_ref`. The
    reference has no backward kernel for the edge softmax, so neither does
    the port. ``EdgeSoftmax.apply(scores, dst, n_dst)``."""

    @staticmethod
    def forward(ctx, scores: torch.Tensor, dst: torch.Tensor,
                n_dst: int) -> torch.Tensor:
        attn = edge_softmax(scores, dst, n_dst)
        ctx.save_for_backward(attn, dst)
        ctx.n_dst = n_dst
        return attn

    @staticmethod
    def backward(ctx, d_attn: torch.Tensor):
        attn, dst = ctx.saved_tensors
        return (ref.edge_softmax_backward_ref(attn, d_attn, dst, ctx.n_dst),
                None, None)
