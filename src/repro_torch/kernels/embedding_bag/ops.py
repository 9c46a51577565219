"""Wrapper over the CUDA embedding-bag kernel (``csrc/embedding_bag.cu``)
and its ``torch.autograd.Function``.

On a CUDA tensor :func:`embedding_bag` checks its inputs, allocates the
output with ``torch.empty``, launches the kernel on the calling thread's
current stream and adds one to :data:`LAUNCHES`; a refused launch raises.
On a CPU tensor it runs the plain version in ``ref.py`` — the only reason
it ever does. There is no fallback from a CUDA tensor to the plain version.

The reference wrapper padded the feature axis to a 128-lane block (a TPU
layout constraint); this one takes any ``D``. The degenerate cases (no bag,
empty bags, ``D == 0``) return zeros without a launch.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag import ref
from repro_torch.kernels.gather_scatter.ops import scatter_add_
from repro_torch.kernels.gather_scatter.ref import scatter_add_ref

# launches since the last reset_launches(); bumped only where the kernel is
# launched (never by the plain version)
LAUNCHES: Dict[str, int] = {"embedding_bag": 0}

KERNEL_MODES = ("kernel", "reference")

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
        lib = _build.load("embedding_bag")
        lib.embedding_bag_f32.argtypes = [
            _P, _P, _P, _I64, _I64, _I64, _I64, ctypes.c_int, _P,
        ]
        lib.embedding_bag_f32.restype = ctypes.c_int
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


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """``out[b] = sum_k table[ids[b, k]]`` over fixed-size bags, divided by
    ``bag_size`` in mean mode: ``table`` ``(V, D)`` float32, ``ids``
    ``(n_bags, bag_size)`` int32 -> ``(n_bags, D)`` float32.

    Ids are read as ``jnp.take`` reads them: an id in ``[-V, 0)`` wraps to
    ``id + V``, any other id outside ``[0, V)`` makes its bag a NaN row."""
    ref._check_mode(mode)
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(
            f"embedding_bag wants table (V, D) and ids (n_bags, bag_size); "
            f"got {tuple(table.shape)} and {tuple(ids.shape)}"
        )
    (V, D), (n_bags, bag_size) = table.shape, ids.shape
    if n_bags == 0 or bag_size == 0 or D == 0:
        return table.new_zeros((n_bags, D))
    if V == 0:
        raise ValueError(f"{n_bags} bags of {bag_size} ids into an empty table")
    if not table.is_cuda:
        return ref.embedding_bag_ref(table, ids, mode)
    dev = table.device
    _check("table", table, torch.float32, dev)
    _check("ids", ids, torch.int32, dev)
    out = torch.empty((n_bags, D), dtype=table.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().embedding_bag_f32(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), V, n_bags,
        bag_size, D, int(mode == "mean"), stream,
    )
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: cudaError {err}")
    LAUNCHES["embedding_bag"] += 1
    return out


class EmbeddingBag(torch.autograd.Function):
    """The bag reduction with a dense, deterministic table gradient:
    ``EmbeddingBag.apply(table, ids, mode, kernels)``.

    ``kernels="kernel"``: the forward is :func:`embedding_bag` (the kernel on
    a CUDA tensor) and the backward writes the rows with the ``scatter_add_``
    kernel wrapper; ``"reference"``: the plain versions of both, on any
    device (an explicit request, never a fallback). The two agree bitwise.
    The reference has no backward kernel for the bag, so the backward is
    :func:`ref.embedding_bag_backward_ref` around the scatter; ``ids`` gets
    no gradient."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor, mode: str,
                kernels: str) -> torch.Tensor:
        if kernels not in KERNEL_MODES:
            raise ValueError(f"kernels={kernels!r} not in {KERNEL_MODES}")
        fwd = embedding_bag if kernels == "kernel" else ref.embedding_bag_ref
        out = fwd(table, ids, mode)
        ctx.save_for_backward(ids)
        ctx.V, ctx.mode, ctx.kernels = table.shape[0], mode, kernels
        return out

    @staticmethod
    def backward(ctx, d_out: torch.Tensor):
        (ids,) = ctx.saved_tensors
        scatter = scatter_add_ if ctx.kernels == "kernel" else scatter_add_ref
        grad = ref.embedding_bag_backward_ref(d_out, ids, ctx.V, ctx.mode,
                                              scatter)
        return grad, None, None, None
