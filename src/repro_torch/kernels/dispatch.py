"""Kernel dispatch: route the forward hot loop to the hand-written CUDA
kernels or to the plain PyTorch reference path, by mode and device.

The :class:`~repro_torch.runtime.forward.ForwardRunner` never launches a
kernel directly — it goes through a :class:`KernelDispatch` built from
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

Every dispatched kernel call records a span ``kernel:<name>.<path>``
(``path`` = ``cuda`` or ``ref``) through ``Counters.record_phase``: on the
exported timeline, outside the stage busy/stall maps. On a CUDA device the
span is the host-side launch time (the kernels run asynchronously).

The training half (``scatter_add_rows``, ``fused_backward_fn``) comes with
the training slice.
"""
from __future__ import annotations

import time

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.gather_scatter import ops

VALID_MODES = ("auto", "reference", "kernel", "kernel-fused")


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
        if self.counters is not None:
            path = "cuda" if t.is_cuda else "ref"
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
