"""Kernel dispatch: route the SSO hot loops to the hand-written CUDA kernels
or to the plain PyTorch / numpy reference path, by mode, device and shape.

The :class:`~repro_torch.runtime.forward.ForwardRunner` and the
:class:`~repro_torch.core.engine.SSOEngine` never launch a kernel directly —
they go through a :class:`KernelDispatch` built from
``PipelineConfig.kernels``:

- ``"auto"`` (default): ``"kernel"`` on a CUDA device, ``"reference"`` on
  the CPU (the reference package's rule: kernels on the accelerator).
- ``"reference"``: host gather of ``GA_p`` + the model's plain PyTorch
  ``apply_layer`` on the device.
- ``"kernel"``: stage whole partition blocks (the stack), regather ``GA_p``
  on the device with the ``gather_rows`` kernel (a bitwise copy), then run
  the same ``apply_layer`` — bitwise equal to ``"reference"`` because the
  layer sees the same ``GA_p`` and its segment sum is deterministic. On a
  CPU device the wrapper runs its plain version (how the CPU tests drive
  the stacked path).
- ``"kernel-fused"``: additionally route the GCN forward through the
  one-kernel ``gather_aggregate``. One fused multiply-add per edge:
  deterministic, but ~1 ulp off the reference's multiply-then-add on rows
  with two or more edges. Opt-in for exactly that reason.

The training half:

- The backward keeps the vjp boundary at ``GA``: :meth:`fused_backward_fn`
  regathers on the device (``gather_rows``, a bitwise copy) and
  differentiates the unchanged layer, so no backward kernel is needed and
  the gradients equal the reference path's bitwise — in ``kernel-fused``
  too (only its forward is fused).
- The ∇A write-back :meth:`KernelDispatch.scatter_add_rows` dispatches by
  shape: a contiguous row run (the loss layer's ``arange``, dense regather
  runs), or a reference mode, takes the host slice-add / ``reduceat`` path
  (:func:`scatter_add_rows_ref`); any other row set runs the ``scatter_add``
  kernel on a device copy of the partition's grad buffer, which is copied
  back (unsorted rows are stable-sorted first). Bitwise equal on the
  engine's sorted duplicate-free row sets.

Every dispatched kernel call records a span ``kernel:<name>.<path>``
(``path`` = ``cuda`` or ``ref``) through ``Counters.record_phase``: on the
exported timeline, outside the stage busy/stall maps. On a CUDA device the
span of a forward or backward kernel is the host-side launch time (the
kernels run asynchronously); the scatter's span includes its blocking
copies.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gather_scatter import ops
from repro_torch.models.gnn.layers import apply_vjp

VALID_MODES = ("auto", "reference", "kernel", "kernel-fused")


def _contiguous_run(rows: np.ndarray) -> bool:
    """``rows`` is one ascending run of consecutive ids (non-empty)."""
    n = rows.size
    r0 = int(rows[0])
    return int(rows[n - 1]) - r0 + 1 == n and (
        n == 1 or bool(np.all(np.diff(rows) == 1))
    )


def scatter_add_rows_ref(
    buf: np.ndarray, rows: np.ndarray, values: np.ndarray
) -> None:
    """Reference host scatter-add: ``buf[rows] += values`` in row order.

    Fast paths, all bit-identical to a bare ``np.add.at`` for the orders
    they accept:

    - contiguous unique row run -> direct slice add (the loss layer's
      ``arange`` scatter and dense regather runs);
    - sorted rows (the engine's ``req_global`` slices are sorted-unique) ->
      segment starts + ``np.add.reduceat``, vectorized instead of
      ``np.add.at``'s per-element inner loop;
    - anything else -> stable-sort first, then the reduceat path.

    Bit-identical to ``add.at`` whenever rows are duplicate-free — which
    every engine call site is. With duplicate rows the segment sum lands on
    the base in ONE rounding instead of per-element (~1 ulp); callers that
    need add.at's exact order for duplicates must not use this.
    """
    n = rows.size
    if n == 0:
        return
    if _contiguous_run(rows):
        r0 = int(rows[0])
        buf[r0 : r0 + n] += values
        return
    if n > 1 and not bool(np.all(rows[1:] >= rows[:-1])):
        order = np.argsort(rows, kind="stable")
        rows = rows[order]
        values = values[order]
    starts = np.flatnonzero(np.concatenate(([True], rows[1:] > rows[:-1])))
    sums = np.add.reduceat(values, starts, axis=0)
    buf[rows[starts]] += sums


class KernelDispatch:
    """Resolves ``PipelineConfig.kernels`` against the device and owns the
    per-kernel call sites. One instance per runner; the layer functions are
    cached per ``(model, activate)``."""

    def __init__(self, mode: str = "auto", counters=None,
                 device: DeviceLike = None):
        if mode not in VALID_MODES:
            raise ValueError(f"kernels={mode!r} not in {VALID_MODES}")
        self.device = resolve_device(device)
        if mode == "auto":
            mode = "kernel" if self.device.type == "cuda" else "reference"
        self.mode = mode
        self.counters = counters
        self._fwd = {}

    @property
    def use_kernels(self) -> bool:
        return self.mode in ("kernel", "kernel-fused")

    @property
    def fused_aggregate(self) -> bool:
        """One-kernel GCN gather+aggregate (FMA accumulation — see module
        docstring). Deterministic but ~1 ulp off the reference order."""
        return self.mode == "kernel-fused"

    def _span(self, name: str, t: torch.Tensor, t0: float) -> None:
        self._record(name, "cuda" if t.is_cuda else "ref", t0)

    def _record(self, name: str, path: str, t0: float) -> None:
        if self.counters is not None:
            self.counters.record_phase(
                f"kernel:{name}.{path}", time.perf_counter() - t0
            )

    def gather_rows(self, stack: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Device regather ``stack[idx]`` — a bitwise copy of ``GA_p``."""
        t0 = time.perf_counter()
        out = ops.gather_rows(stack, idx)
        self._span("gather_rows", stack, t0)
        return out

    def gather_aggregate(self, stack, erows, dst, w, n_dst) -> torch.Tensor:
        t0 = time.perf_counter()
        out = ops.gather_aggregate(stack, erows, dst, w, n_dst)
        self._span("gather_aggregate", stack, t0)
        return out

    def fused_forward_fn(self, spec, activate: bool):
        """``f(layer, stack, idx, topo) -> out`` for one forward layer over
        the staged partition stack. Default: regather on the device
        (:meth:`gather_rows`) and run the unchanged ``apply_layer`` — same
        ``GA_p``, same bits as the reference path. ``"kernel-fused"`` + GCN
        gets the one-kernel gather+aggregate instead."""
        key = (spec.name, activate)
        if key not in self._fwd:
            if spec.name == "gcn" and self.fused_aggregate:
                def f(layer, stack, idx, topo):
                    # only the real-edge prefix goes to the kernel: the
                    # padding tail (weight 0) would add exactly +0 to a sum
                    # that is never -0, so dropping it leaves the bits
                    # unchanged and keeps dst sorted (the reference
                    # re-points the padding at the last row instead, whose
                    # block would then walk up to half of e_pad zero edges)
                    e = topo.n_real_edges
                    agg = self.gather_aggregate(
                        stack, idx.index_select(0, topo.src[:e]),
                        topo.dst[:e], topo.edge_weight[:e], topo.n_dst,
                    )
                    h = layer.lin(agg)
                    return torch.relu(h) if activate else h
            else:
                apply = spec.apply_layer

                def f(layer, stack, idx, topo):
                    return apply(layer, self.gather_rows(stack, idx), topo,
                                 activate=activate)

            self._fwd[key] = f
        return self._fwd[key]

    def fused_backward_fn(self, spec, activate: bool):
        """``f(layer, stack, idx, topo, d_out) -> (dp, dga)`` for one
        backward layer over the staged partition stack: regather ``GA`` on
        the device (:meth:`gather_rows`, a bitwise copy), then the unchanged
        layer's vjp at ``GA`` (:func:`apply_vjp`) — the reference backward's
        arithmetic on the same ``GA``, so the same bits."""
        apply = spec.apply_layer

        def f(layer, stack, idx, topo, d_out):
            return apply_vjp(apply, layer, self.gather_rows(stack, idx),
                             topo, d_out, activate)

        return f

    # ------------------------------------------------------- grad write-back
    def scatter_add_rows(
        self, buf: np.ndarray, rows: np.ndarray, values: np.ndarray
    ) -> None:
        """In-place ``buf[rows] += values`` — the backward's ∇A write-back
        into a partition's host grad buffer. Kernel path: the ``scatter_add``
        kernel on a device copy of ``buf`` (unsorted rows stable-sorted
        first, so duplicates still add in input order), copied back into
        ``buf``. Both paths are bitwise equal on the engine's sorted
        duplicate-free row sets."""
        n = rows.size
        if n == 0:
            return
        t0 = time.perf_counter()
        if not self.use_kernels or _contiguous_run(rows):
            # a contiguous run is a slice add on every path and beats a
            # device round trip — shape-based dispatch
            scatter_add_rows_ref(buf, rows, values)
            self._record("scatter_add", "ref", t0)
            return
        if n > 1 and not bool(np.all(rows[1:] >= rows[:-1])):
            order = np.argsort(rows, kind="stable")
            rows = rows[order]
            values = values[order]
        dev = self.device
        base = torch.from_numpy(buf).to(dev, copy=True)
        ops.scatter_add_(
            base,
            torch.from_numpy(np.ascontiguousarray(rows, np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(values)).to(dev),
        )
        np.copyto(buf, base.cpu().numpy())
        self._span("scatter_add", base, t0)
