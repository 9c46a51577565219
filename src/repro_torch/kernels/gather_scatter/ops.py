"""Wrappers over the CUDA gather/scatter kernels (``csrc/gather_scatter.cu``).

On a CUDA tensor a wrapper checks its inputs, allocates the output with
``torch.empty`` (``scatter_add_`` writes into its ``base`` instead),
launches the kernel on the calling thread's current stream and adds one to
its entry in :data:`LAUNCHES`; a refused launch raises. On a CPU tensor it
runs the plain version in ``ref.py`` — the only reason it ever does. There
is no fallback from a CUDA tensor to the plain version.

The reference wrappers padded the feature axis to a 128-lane block (a TPU
layout constraint); these take any ``D``. The degenerate early returns are
kept: an empty gather / aggregate returns zeros and an empty scatter leaves
``base`` as it is, without a launch.

:func:`segment_sum` replaces no TPU kernel (the JAX package leaves its
segment sums to XLA): it is the card's route of the layers' ``seg_sum``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_scatter import ref
from repro_torch.kernels.heavy_rows import (
    heavy_slots, plan_rows, plan_scratch,
)

# launches per kernel since the last reset_launches(); bumped only where a
# kernel is launched (never by the plain versions)
LAUNCHES: Dict[str, int] = {
    "gather_rows": 0, "gather_aggregate": 0, "scatter_add": 0,
    "segment_sum": 0,
}

# gather_aggregate: a row with more edges is a heavy row, split into
# 32-column slabs spread over the card (chosen on the H100:
# scripts/pt_heavy_rows.py)
HEAVY_EDGES = 256

# segment_sum: a segment of more edges is summed in chunks of this many
# consecutive edges, each chunk on its own threads, and the chunk sums are
# added in chunk order. A chunk's chain of adds waits on its row loads, so
# the shortest of 256, 512, 1,024 and 2,048 was the fastest on the H100
# (scripts/pt_segment_sum.py: a GCN step's sums 27.8 / 34.9 / 47.2 / 78.0 ms)
SEGMENT_CHUNK = 256

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
        lib = _build.load("gather_scatter")
        lib.gather_rows_f32.argtypes = [_P, _P, _P, _I64, _I64, _P]
        lib.gather_rows_f32.restype = ctypes.c_int
        lib.gather_aggregate_f32.argtypes = [
            _P, _P, _P, _P, _P, _I64, _I64, _I64, _P, _P, _I64, _I64, _P,
        ]
        lib.gather_aggregate_f32.restype = ctypes.c_int
        lib.scatter_add_f32.argtypes = [_P, _P, _P, _I64, _I64, _P]
        lib.scatter_add_f32.restype = ctypes.c_int
        lib.scatter_add_host_f32.argtypes = [_P, _P, _P, _I64, _I64, _P]
        lib.scatter_add_host_f32.restype = ctypes.c_int
        lib.heavy_rows_plan.argtypes = [_P, _I64, _I64, _I64, _P, _P, _I64, _P]
        lib.heavy_rows_plan.restype = ctypes.c_int
        lib.segment_sum_f32.argtypes = [
            _P, _P, _P, _I64, _I64, _I64, _I64, _P, _P, _P, _P, _P,
        ]
        lib.segment_sum_f32.restype = ctypes.c_int
        _bound = lib
    return _bound


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: cudaError {err}")


def row_plan(dst: torch.Tensor, n_dst: int, heavy_edges: int):
    """The row plan that ``gather_aggregate`` and ``edge_softmax`` make
    inside their launch, alone: the card's planner on a CUDA tensor, its
    plain version :func:`~repro_torch.kernels.heavy_rows.plan_rows` on a
    CPU one. Returns ``(starts, heavy)``. Not counted in :data:`LAUNCHES`:
    no path runs it by itself."""
    if not dst.is_cuda:
        return plan_rows(dst, n_dst, heavy_edges)
    _check("dst", dst, torch.int32, 1, dst.device)
    if heavy_edges < 0:
        raise ValueError(f"heavy_edges must be >= 0, got {heavy_edges}")
    E = dst.shape[0]
    starts, heavy = plan_scratch(E, n_dst, heavy_edges, dst.device)
    k = heavy_slots(E, n_dst, heavy_edges)
    err = _lib().heavy_rows_plan(
        dst.data_ptr(), E, n_dst, heavy_edges, starts.data_ptr(),
        heavy.data_ptr(), k,
        torch.cuda.current_stream(dst.device).cuda_stream,
    )
    _raise_on(err, "heavy_rows_plan")
    return starts, heavy[:k]


def gather_rows(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` (bitwise row copy). ``table`` ``(N, D)`` float32,
    ``rows`` ``(R,)`` int32 with values in ``[0, N)``."""
    if table.dim() != 2 or rows.dim() != 1:
        raise ValueError(
            f"gather_rows wants table (N, D) and rows (R,); got "
            f"{tuple(table.shape)} and {tuple(rows.shape)}"
        )
    R, D = rows.shape[0], table.shape[1]
    if R == 0 or D == 0:
        return table.new_zeros((R, D))
    if not table.is_cuda:
        return ref.gather_rows_ref(table, rows)
    _check("table", table, torch.float32, 2, table.device)
    _check("rows", rows, torch.int32, 1, table.device)
    out = torch.empty((R, D), dtype=table.dtype, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _lib().gather_rows_f32(
        table.data_ptr(), rows.data_ptr(), out.data_ptr(), R, D, stream,
    )
    _raise_on(err, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out


def gather_aggregate(
    table: torch.Tensor,
    erows: torch.Tensor,
    dst: torch.Tensor,
    w: torch.Tensor,
    n_dst: int,
) -> torch.Tensor:
    """``out[dst[e]] += w[e] * table[erows[e]]`` over zeros, fused: each
    output row sums its edges in edge order, one fused multiply-add per
    edge (bitwise the exact oracle ``ref.gather_aggregate_fma_np``).

    ``dst`` must be sorted ascending with values in ``[0, n_dst)`` (the
    real-edge prefix of a plan's topology is; the dispatcher passes only
    that prefix).

    On the card the kernel's launch first makes the row plan on the device
    (``kernels/csrc/heavy_rows.cuh``, whose plain version is
    :func:`~repro_torch.kernels.heavy_rows.plan_rows`; no host
    synchronisation) into scratch allocated here. A row with more than
    :data:`HEAVY_EDGES` (256) edges is heavy: it is split into slabs of 32
    lanes' columns (128 columns at D % 4 == 0 with 16-byte aligned bases,
    else 32), each a work item of a persistent grid, rows with more than
    16 times as many edges first, whose source slabs stream through a
    64 KB shared-memory ring (``cp.async``, 128 edges ahead of the FMA
    chain at 128 columns, 512 at 32). Every other row takes one block, in
    row order. Each output element is still one FMA chain in edge order,
    so the split changes no bit."""
    if table.dim() != 2 or erows.dim() != 1 or dst.dim() != 1 or w.dim() != 1:
        raise ValueError("gather_aggregate wants table (N, D) and 1-D edges")
    E, D = erows.shape[0], table.shape[1]
    if dst.shape[0] != E or w.shape[0] != E:
        raise ValueError(
            f"erows/dst/w lengths differ: {E}, {dst.shape[0]}, {w.shape[0]}"
        )
    if E == 0 or n_dst == 0 or D == 0:
        return table.new_zeros((n_dst, D))
    if not table.is_cuda:
        return ref.gather_aggregate_ref(table, erows, dst, w, n_dst)
    dev = table.device
    _check("table", table, torch.float32, 2, dev)
    _check("erows", erows, torch.int32, 1, dev)
    _check("dst", dst, torch.int32, 1, dev)
    _check("w", w, torch.float32, 1, dev)
    out = torch.empty((n_dst, D), dtype=table.dtype, device=dev)
    starts, heavy = plan_scratch(E, n_dst, HEAVY_EDGES, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().gather_aggregate_f32(
        table.data_ptr(), erows.data_ptr(), dst.data_ptr(), w.data_ptr(),
        out.data_ptr(), E, n_dst, D, starts.data_ptr(), heavy.data_ptr(),
        heavy_slots(E, n_dst, HEAVY_EDGES), HEAVY_EDGES, stream,
    )
    _raise_on(err, "gather_aggregate")
    LAUNCHES["gather_aggregate"] += 1
    return out


def scatter_add_(base: torch.Tensor, rows: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """``base[rows[i]] += values[i]`` in place; returns ``base``.

    ``base`` ``(N, D)`` float32, ``rows`` ``(R,)`` int32 sorted ascending
    with values in ``[0, N)`` (duplicates add in input order, one rounding
    each: bitwise ``np.add.at``), ``values`` ``(R, D)`` float32. Rows not in
    ``rows`` keep their bits. Unsorted rows would give two threads one
    output row; the dispatcher stable-sorts before calling."""
    if base.dim() != 2 or rows.dim() != 1 or values.dim() != 2:
        raise ValueError(
            f"scatter_add_ wants base (N, D), rows (R,) and values (R, D); "
            f"got {tuple(base.shape)}, {tuple(rows.shape)} and "
            f"{tuple(values.shape)}"
        )
    R, D = rows.shape[0], base.shape[1]
    if tuple(values.shape) != (R, D):
        raise ValueError(
            f"values {tuple(values.shape)} do not match rows ({R},) and "
            f"base width {D}"
        )
    if R == 0 or D == 0:
        return base
    if not base.is_cuda:
        return ref.scatter_add_ref(base, rows, values)
    dev = base.device
    _check("base", base, torch.float32, 2, dev)
    _check("rows", rows, torch.int32, 1, dev)
    _check("values", values, torch.float32, 2, dev)
    torch.ops.repro_torch.scatter_add_(base, rows, values)
    return base


def scatter_add_host_(base: torch.Tensor, rows: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """:func:`scatter_add_` into a ``base`` that lies in page-locked host
    memory: the ``scatter_add`` kernel reads and writes the touched rows of
    ``base`` in place through its mapped device address, so only those rows
    cross the link. ``rows`` and ``values`` are on the card; the launch is
    queued on the values' device's current stream and not waited for, so
    the caller synchronises before it reads ``base`` on the host. Same
    order and bits as :func:`scatter_add_`.

    Raises for a ``base`` that is on the card or pageable and for values on
    the CPU: there is no plain version to fall back to."""
    if base.dim() != 2 or rows.dim() != 1 or values.dim() != 2:
        raise ValueError(
            f"scatter_add_host_ wants base (N, D), rows (R,) and values "
            f"(R, D); got {tuple(base.shape)}, {tuple(rows.shape)} and "
            f"{tuple(values.shape)}"
        )
    R, D = rows.shape[0], base.shape[1]
    if tuple(values.shape) != (R, D):
        raise ValueError(
            f"values {tuple(values.shape)} do not match rows ({R},) and "
            f"base width {D}"
        )
    if base.is_cuda or not values.is_cuda:
        raise ValueError(
            f"scatter_add_host_ wants base in host memory and values on the "
            f"card; got base on {base.device}, values on {values.device}"
        )
    _check("base", base, torch.float32, 2, base.device)
    if not base.is_pinned():
        raise ValueError("base is pageable: the card cannot reach it in place")
    dev = values.device
    _check("rows", rows, torch.int32, 1, dev)
    _check("values", values, torch.float32, 2, dev)
    if R == 0 or D == 0:
        return base
    err = _lib().scatter_add_host_f32(
        base.data_ptr(), rows.data_ptr(), values.data_ptr(), R, D,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "scatter_add_host")
    LAUNCHES["scatter_add"] += 1
    return base


class _SegmentSum(torch.autograd.Function):
    """:func:`segment_sum` under autograd: the backward gathers the
    cotangent's rows, ``grad[seg]``, exactly (``index_put_``'s own)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, seg: torch.Tensor, n: int):
        ctx.save_for_backward(seg)
        if not x.is_cuda:
            return ref.segment_sum_ref(x, seg, n, SEGMENT_CHUNK)
        return torch.ops.repro_torch.segment_sum(x, seg, n)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (seg,) = ctx.saved_tensors
        return grad.index_select(0, seg), None, None


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``out[seg[i]] += x[i]`` over zeros, ``out`` of shape ``(n,) +
    x.shape[1:]``, the same bits on every run: ``x`` ``(E, *trailing)``
    float32 contiguous (read as ``(E, D)``), ``seg`` ``(E,)`` int32 in any
    order; an id outside ``[0, n)`` falls in no segment. Differentiable in
    ``x`` (the backward is ``grad.index_select(0, seg)``).

    The order: a segment's edges are taken in edge order. A segment of at
    most :data:`SEGMENT_CHUNK` edges sums them in that order from +0, one
    rounding an edge: bitwise a sequential ``np.add.at`` and the CPU's
    ``index_add_``, and at 32 columns or more the card's
    ``index_put_(accumulate=True)``. A longer one is cut into chunks of
    ``SEGMENT_CHUNK`` consecutive edges from its start; each chunk sums in
    edge order from +0 and the chunk sums add in chunk order.

    On the card the ids are stable-sorted with their positions
    (``torch.sort``), then one launch (``csrc/gather_scatter.cu``,
    ``segment_sum_f32``) finds each segment's edges, sums the chunks of the
    long segments on threads of their own, and each segment's short sum or
    its chunk sums in order: no atomics and no host synchronisation; its
    scratch (the segments' starts, the chunk slots and sums, at most
    ``2 * ceil(E / SEGMENT_CHUNK)`` rows) is allocated here. On a CPU tensor
    :func:`~repro_torch.kernels.gather_scatter.ref.segment_sum_ref`, the
    plain version, gives the same bits."""
    if x.dim() < 1 or seg.dim() != 1 or seg.shape[0] != x.shape[0]:
        raise ValueError(
            f"segment_sum wants x (E, ...) and seg (E,); got "
            f"{tuple(x.shape)} and {tuple(seg.shape)}"
        )
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if x.is_cuda:
        _check("x", x, torch.float32, x.dim(), x.device)
        _check("seg", seg, torch.int32, 1, x.device)
    elif seg.is_cuda:
        raise ValueError(f"seg is on {seg.device}, expected {x.device}")
    if x.shape[0] == 0 or n == 0 or math.prod(x.shape[1:]) == 0:
        return x.new_zeros((n,) + tuple(x.shape[1:]))
    return _SegmentSum.apply(x, seg, n)


# The launches as operators of their own, so that a fake tensor (the dry
# run's trace) gets through them without a launch.

@torch.library.custom_op("repro_torch::segment_sum", mutates_args=())
def _segment_sum_launch(x: torch.Tensor, seg: torch.Tensor,
                        n: int) -> torch.Tensor:
    dev = x.device
    E = x.shape[0]
    D = x.numel() // E
    keys, perm = torch.sort(seg, stable=True)
    n_slots = 2 * -(-E // SEGMENT_CHUNK)
    starts = torch.empty(n + 1, dtype=torch.int64, device=dev)
    first = torch.empty(n_slots, dtype=torch.int64, device=dev)
    chunks = torch.empty((n_slots, D), dtype=x.dtype, device=dev)
    out = torch.empty((n,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
    err = _lib().segment_sum_f32(
        x.data_ptr(), keys.data_ptr(), perm.data_ptr(), E, n, D,
        SEGMENT_CHUNK, starts.data_ptr(), first.data_ptr(),
        chunks.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "segment_sum")
    LAUNCHES["segment_sum"] += 1
    return out


@_segment_sum_launch.register_fake
def _(x, seg, n):
    return x.new_empty((n,) + tuple(x.shape[1:]))


@torch.library.custom_op("repro_torch::scatter_add_", mutates_args=("base",))
def _scatter_add_launch(base: torch.Tensor, rows: torch.Tensor,
                        values: torch.Tensor) -> None:
    stream = torch.cuda.current_stream(base.device).cuda_stream
    err = _lib().scatter_add_f32(
        base.data_ptr(), rows.data_ptr(), values.data_ptr(), rows.shape[0],
        base.shape[1], stream,
    )
    _raise_on(err, "scatter_add")
    LAUNCHES["scatter_add"] += 1


@_scatter_add_launch.register_fake
def _(base, rows, values):
    return None
