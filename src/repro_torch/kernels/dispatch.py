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
  one-kernel ``gather_aggregate`` (one fused multiply-add per edge:
  deterministic, but ~1 ulp off the reference's multiply-then-add on rows
  with two or more edges), and GAT's attention softmax, in its forward and
  in its backward's recompute, through the ``edge_softmax`` kernel
  (:meth:`KernelDispatch.edge_softmax`; it sums each destination's
  exponentials in its own warp order, so it too is deterministic but a few
  ulp off the reference's segment sum). Opt-in for exactly that reason:
  ``kernel`` == ``reference`` bitwise holds for every family, and
  ``kernel-fused`` is held to a tolerance.

The training half:

- The backward keeps the vjp boundary at ``GA``: :meth:`fused_backward_fn`
  regathers on the device (``gather_rows``, a bitwise copy) and
  differentiates the layer, so no backward kernel is needed. Its gradients
  equal the reference path's bitwise, in ``kernel-fused`` too for every
  family but GAT, whose recompute runs the ``edge_softmax`` kernel forward
  (its backward is the plain softmax vjp, ``EdgeSoftmax``).
- The ∇A write-back :meth:`KernelDispatch.scatter_add_rows` dispatches by
  what its input shows: a contiguous row run (the loss layer's ``arange``,
  dense regather runs), or a reference mode, takes the host slice-add /
  ``reduceat`` path (:func:`scatter_add_rows_ref`); any other row set runs
  the ``scatter_add`` kernel — in place in the partition's grad buffer when
  that buffer is page-locked and the values are on the card (the engine's
  case on the card), else on a device copy of the buffer, which is copied
  back (unsorted rows are stable-sorted first). Bitwise equal on the
  engine's sorted duplicate-free row sets.

Every dispatched kernel call records a span ``kernel:<name>.<path>``
(``path`` = ``cuda`` or ``ref``) through ``Counters.record_phase``: on the
exported timeline, outside the stage busy/stall maps. On a CUDA device the
span of a forward or backward kernel is the host-side launch time (the
kernels run asynchronously), as is the span of an in-place scatter; the
span of a scatter's round trip includes its blocking copies.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.edge_softmax.ops import EdgeSoftmax
from repro_torch.kernels.gather_scatter import ops
from repro_torch.models.gnn.layers import LocalTopo, apply_vjp, apply_with

VALID_MODES = ("auto", "reference", "kernel", "kernel-fused")


def _page_locked(buf: np.ndarray) -> bool:
    """``buf`` lies in page-locked host memory, which the card reaches in
    place (``Tensor.is_pinned``: ``cudaPointerGetAttributes``)."""
    return torch.cuda.is_available() and torch.from_numpy(buf).is_pinned()


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
        """One-kernel GCN gather+aggregate and GAT's kernel softmax (see
        the module docstring). Deterministic but a few ulp off the
        reference order."""
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
        """``f(layer, stack, idx, topo, side=None) -> out`` for one forward
        layer over the staged partition stack (``side``: the staged rows of
        the layer's side input, ``GNNSpec.side_input``). Default: regather
        on the device (:meth:`gather_rows`) and run the unchanged
        ``apply_layer`` — same ``GA_p``, same bits as the reference path. In
        ``"kernel-fused"`` a family's ``spec.fused_forward`` (GCN: the
        one-kernel gather+aggregate) or ``spec.fused_apply`` (GAT: the
        kernel softmax) takes its place."""
        key = (spec.name, activate)
        if key not in self._fwd:
            if self.fused_aggregate and spec.fused_forward is not None:
                fused = spec.fused_forward

                def f(layer, stack, idx, topo, side=None):
                    return fused(self, layer, stack, idx, topo, activate)
            else:
                apply = self._apply_fn(spec)

                def f(layer, stack, idx, topo, side=None):
                    return apply_with(apply, layer,
                                      self.gather_rows(stack, idx), topo,
                                      activate, side)

            self._fwd[key] = f
        return self._fwd[key]

    def _apply_fn(self, spec):
        """The layer function the stacked paths run: the family's own, or
        its ``spec.fused_apply`` variant in ``"kernel-fused"``."""
        if self.fused_aggregate and spec.fused_apply is not None:
            return spec.fused_apply(self)
        return spec.apply_layer

    def edge_softmax(self, score: torch.Tensor,
                     topo: LocalTopo) -> torch.Tensor:
        """GAT's attention softmax through the ``edge_softmax`` kernel
        (differentiable: :class:`EdgeSoftmax`). Only the real-edge prefix
        ``[0, n_real_edges)`` goes to the kernel — its ``dst`` is sorted,
        while the padding tail points back at row 0 — and the padding gets
        attention 0, as the reference's mask gives it. The kernel clamps the
        denominator at 1e-30 where ``gat_softmax`` clamps at 1e-9: the same
        result, since a row with a real edge sums ``exp(0) = 1`` for its
        maximum (denominator >= 1) and a row with none has no edge to
        divide."""
        t0 = time.perf_counter()
        e = topo.n_real_edges
        attn = EdgeSoftmax.apply(score[:e], topo.dst[:e], topo.n_dst)
        self._span("edge_softmax", score, t0)
        pad = score.shape[0] - e
        if pad:
            attn = torch.cat([attn, attn.new_zeros((pad,) + attn.shape[1:])])
        return attn

    def fused_backward_fn(self, spec, activate: bool):
        """``f(layer, stack, idx, topo, d_out, side=None) -> (dp, dga)``
        (``(dp, dga, dside)`` with a ``side`` input) for one backward layer
        over the staged partition stack: regather ``GA`` on the device
        (:meth:`gather_rows`, a bitwise copy), then the layer's vjp at
        ``GA`` (:func:`apply_vjp`) — the reference backward's arithmetic on
        the same ``GA``, so the same bits (GAT in ``"kernel-fused"``
        recomputes its softmax with the kernel)."""
        apply = self._apply_fn(spec)

        def f(layer, stack, idx, topo, d_out, side=None):
            return apply_vjp(apply, layer, self.gather_rows(stack, idx),
                             topo, d_out, activate, side)

        return f

    # ------------------------------------------------------- grad write-back
    def scatter_add_rows(
        self, buf: np.ndarray, rows: np.ndarray, values: np.ndarray,
        dev_rows: Optional[torch.Tensor] = None,
        dev_values: Optional[torch.Tensor] = None,
    ) -> bool:
        """In-place ``buf[rows] += values`` — the backward's ∇A write-back
        into a partition's host grad buffer. ``values`` are on the host;
        ``dev_values`` (and optionally ``dev_rows``, int32) are the same on
        the card, where the backward computed them. The path follows what
        the input shows:

        - a reference mode or a contiguous row run: the host slice-add /
          ``reduceat`` (:func:`scatter_add_rows_ref`);
        - a page-locked ``buf`` with ``dev_values``: the ``scatter_add``
          kernel adds into ``buf`` in place through its mapped address
          (:func:`ops.scatter_add_host_`), only the touched rows crossing
          the link. The launch is queued and not waited for: returns True,
          and the caller waits on the current stream before it reads or
          releases ``buf``;
        - any other row set (a pageable ``buf``): the round trip, the kernel
          on a device copy of ``buf`` copied back.

        Unsorted rows are stable-sorted first, so duplicates still add in
        input order. Every path is bitwise equal on the engine's sorted
        duplicate-free row sets. ``Counters.scatter_inplace_pairs`` /
        ``scatter_copy_pairs`` count the calls that took the last two paths
        and ``scatter_link_bytes`` the bytes of ``buf`` they moved across
        the link, both ways."""
        n = rows.size
        if n == 0:
            return False
        t0 = time.perf_counter()
        if not self.use_kernels or _contiguous_run(rows):
            # a contiguous run is a slice add on every path and beats a
            # device round trip — shape-based dispatch
            scatter_add_rows_ref(buf, rows, values)
            self._record("scatter_add", "ref", t0)
            return False
        order = None
        if n > 1 and not bool(np.all(rows[1:] >= rows[:-1])):
            order = np.argsort(rows, kind="stable")
            rows = rows[order]
            values = values[order]
        if dev_values is not None and _page_locked(buf):
            dev = dev_values.device
            if order is not None:
                dev_values = dev_values[torch.from_numpy(order).to(dev)]
            if order is not None or dev_rows is None:
                dev_rows = torch.from_numpy(
                    np.ascontiguousarray(rows, np.int32)).to(dev)
            ops.scatter_add_host_(torch.from_numpy(buf), dev_rows, dev_values)
            distinct = 1 + int(np.count_nonzero(rows[1:] != rows[:-1]))
            self._count_pair("scatter_inplace_pairs",
                             2 * distinct * buf.shape[1] * buf.itemsize)
            self._span("scatter_add", dev_values, t0)
            return True
        dev = self.device
        base = torch.from_numpy(buf).to(dev, copy=True)
        ops.scatter_add_(
            base,
            torch.from_numpy(np.ascontiguousarray(rows, np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(values)).to(dev),
        )
        np.copyto(buf, base.cpu().numpy())
        self._count_pair("scatter_copy_pairs",
                         2 * buf.nbytes if base.is_cuda else 0)
        self._span("scatter_add", base, t0)
        return False

    def _count_pair(self, field: str, link_bytes: int) -> None:
        if self.counters is not None:
            self.counters.bump_many(**{field: 1,
                                       "scatter_link_bytes": link_bytes})
