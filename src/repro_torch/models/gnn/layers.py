"""GNN layers for the port: the partition-wise forward and its vjp, shared
by the SSO training engine, the offloaded inference engine and the
full-graph oracle.

Every layer is an ``nn.Module`` holding its weights, plus a functional
``apply(layer, ga, topo, activate) -> (n_dst, d_out)`` where ``ga`` holds the
gathered source activations of the work unit (the paper's ``GA_p^{l-1}``)
and ``topo`` is the partition-local (or full-graph) edge structure.
:func:`apply_vjp` differentiates one layer at ``ga`` (the engine's
per-(layer, unit) backward).

Message passing is an edge gather (:func:`edge_gather`) followed by
:func:`seg_sum`, a segment sum over ``dst`` that gives the same bits on
every run on either device (see its docstring); the gather's backward is
the same segment sum over ``src``. Forward and backward are therefore
deterministic — the property the pipelined == serial and kernel ==
reference checks rest on. Only GCN is ported so far.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class LocalTopo:
    """Partition-local (or full-graph) topology, all tensors on one device.

    ``src``/``dst`` index into the gathered-activation tensor / output rows.
    Padded edges carry ``edge_mask == 0`` and point at slot 0.
    """

    src: torch.Tensor          # int32 (E,) rows of `ga`
    dst: torch.Tensor          # int32 (E,) output rows in [0, n_dst)
    n_dst: int
    edge_weight: torch.Tensor  # float32 (E,) (GCN sym-norm; 1.0 otherwise) * mask
    edge_mask: torch.Tensor    # float32 (E,) 1=real edge, 0=padding
    in_deg: torch.Tensor       # float32 (n_dst,) true in-degree (>=1 clamp applied)
    dst_self: torch.Tensor     # int32 (n_dst,) row of each dst vertex inside `ga`
    n_real_edges: int          # real edges are the prefix [0, n_real_edges)

    def to(self, device: DeviceLike) -> "LocalTopo":
        return LocalTopo(
            src=self.src.to(device), dst=self.dst.to(device),
            n_dst=self.n_dst,
            edge_weight=self.edge_weight.to(device),
            edge_mask=self.edge_mask.to(device),
            in_deg=self.in_deg.to(device),
            dst_self=self.dst_self.to(device),
            n_real_edges=self.n_real_edges,
        )

    @property
    def device(self) -> torch.device:
        return self.src.device


def seg_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``out[seg[i]] += x[i]`` over zeros — the counterpart of the
    reference's ``jax.ops.segment_sum``.

    Deterministic by construction on both devices: ``index_add_`` on a
    CUDA tensor uses float atomics (order varies from run to run), so the
    CUDA path uses ``index_put_(accumulate=True)``, which stable-sorts the
    indices and sums each segment without atomics (in edge order at widths
    of 32 columns and more; below that its order is its own, and it differs
    from a sequential ``np.add.at`` by an ulp). On the CPU, ``index_add_``
    is the sequential loop (while the CPU ``index_put_`` accumulate is the
    parallel one)."""
    out = x.new_zeros((n,) + tuple(x.shape[1:]))
    if x.is_cuda:
        out.index_put_((seg.long(),), x, accumulate=True)
    else:
        out.index_add_(0, seg, x)
    return out


class _EdgeGather(torch.autograd.Function):
    """``ga[src]`` whose backward is :func:`seg_sum` over ``src``. PyTorch's
    own ``index_select`` backward is ``index_add_``, which uses float
    atomics on a CUDA tensor (the summed ``dGA`` would change from run to
    run); on the CPU the two are the same sequential loop."""

    @staticmethod
    def forward(ctx, ga: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(src)
        ctx.n_rows = ga.shape[0]
        return ga.index_select(0, src)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (src,) = ctx.saved_tensors
        return seg_sum(grad, src, ctx.n_rows), None


def edge_gather(ga: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``ga[src]`` (rows of ``ga`` per edge) with a deterministic backward."""
    return _EdgeGather.apply(ga, src)


def apply_vjp(apply: Callable, layer: nn.Module, ga: torch.Tensor,
              topo: "LocalTopo", d_out: torch.Tensor, activate: bool):
    """vjp of one layer at ``ga``: ``({param_name: dL/dparam}, dL/dga)``
    for the cotangent ``d_out`` of ``apply(layer, ga, topo, activate)``.
    Recomputes the layer's intermediates (the regather engine keeps none)
    under ``enable_grad`` — the forward runner computes under ``no_grad``."""
    names, params = zip(*layer.named_parameters())
    ga = ga.detach().requires_grad_(True)
    with torch.enable_grad():
        out = apply(layer, ga, topo, activate=activate)
        *dp, dga = torch.autograd.grad(out, [*params, ga], d_out)
    return dict(zip(names, dp)), dga


# --------------------------------------------------------------------------
# GCN (Kipf & Welling) — the paper's primary model
# --------------------------------------------------------------------------

class GCNLayer(nn.Module):
    """One GCN layer's weights: ``lin`` maps the aggregate to ``d_out``."""

    def __init__(
        self, d_in: int, d_out: int, *, generator: torch.Generator,
        device: DeviceLike = None,
    ):
        super().__init__()
        # skip_init: no draw from the global RNG; weights come from the
        # explicit generator (or from converted reference params)
        self.lin = nn.utils.skip_init(nn.Linear, d_in, d_out, device=device)
        with torch.no_grad():
            # the reference's N(0, 1/d_in) init, drawn on the CPU so one
            # seed gives the same weights on every device
            w = torch.randn((d_out, d_in), generator=generator)
            self.lin.weight.copy_(w * (1.0 / np.sqrt(d_in)))
            self.lin.bias.zero_()


def gcn_apply(layer: GCNLayer, ga: torch.Tensor, topo: LocalTopo,
              activate: bool = True) -> torch.Tensor:
    """Gather, scale by ``edge_weight``, segment sum over ``dst``, dense,
    relu — the reference ``gcn_apply``'s order. The scale is applied in
    place on the freshly gathered messages (same single rounding, one
    ``(E, d)`` tensor live instead of two)."""
    msg = edge_gather(ga, topo.src)
    msg.mul_(topo.edge_weight[:, None])
    agg = seg_sum(msg, topo.dst, topo.n_dst)
    del msg
    h = layer.lin(agg)
    return torch.relu(h) if activate else h


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GNNSpec:
    name: str
    layer_cls: Callable[..., nn.Module]
    apply_layer: Callable[..., torch.Tensor]

    def init(self, generator: torch.Generator, d_in: int, d_hidden: int,
             d_out: int, n_layers: int,
             device: DeviceLike = None) -> nn.ModuleList:
        device = resolve_device(device)
        dims = [d_in] + [d_hidden] * (n_layers - 1) + [d_out]
        return nn.ModuleList(
            self.layer_cls(dims[i], dims[i + 1], device=device,
                           generator=generator)
            for i in range(n_layers)
        )


GNN_REGISTRY: Dict[str, GNNSpec] = {
    "gcn": GNNSpec("gcn", GCNLayer, gcn_apply),
}


def get_gnn(name: str) -> GNNSpec:
    if name not in GNN_REGISTRY:
        raise KeyError(
            f"GNN model {name!r} is not ported yet (ported: "
            f"{sorted(GNN_REGISTRY)})"
        )
    return GNN_REGISTRY[name]


# --------------------------------------------------------------------------
# Full-graph oracle helpers
# --------------------------------------------------------------------------

def full_graph_topo(
    indptr: np.ndarray,
    indices: np.ndarray,
    n_nodes: int,
    edge_weight: Optional[np.ndarray] = None,
    device: DeviceLike = None,
) -> LocalTopo:
    device = resolve_device(device)
    dst = np.repeat(np.arange(n_nodes, dtype=np.int32), np.diff(indptr))
    e = indices.shape[0]
    ew = edge_weight if edge_weight is not None else np.ones(e, np.float32)
    deg = np.maximum(np.diff(indptr), 1).astype(np.float32)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return LocalTopo(
        src=t(indices, np.int32),
        dst=t(dst, np.int32),
        n_dst=n_nodes,
        edge_weight=t(ew, np.float32),
        edge_mask=torch.ones((e,), dtype=torch.float32, device=device),
        in_deg=t(deg, np.float32),
        dst_self=torch.arange(n_nodes, dtype=torch.int32, device=device),
        n_real_edges=e,
    )


def full_graph_forward(spec: GNNSpec, params: List, x, topo: LocalTopo):
    """Dense whole-graph forward; ``x`` is a tensor or a numpy array (moved
    to the topology's device)."""
    h = torch.as_tensor(x, device=topo.device)
    for i, layer in enumerate(params):
        h = spec.apply_layer(layer, h, topo, activate=(i < len(params) - 1))
    return h


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 n_total: Optional[int] = None) -> torch.Tensor:
    """Mean cross-entropy over nodes (sum / ``n_total`` form, so partitions
    compose exactly)."""
    n_total = n_total if n_total is not None else logits.shape[0]
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(1, labels.long()[:, None])[:, 0]
    return -ll.sum() / n_total


def full_graph_loss(spec: GNNSpec, params: List, x, topo: LocalTopo, labels):
    """Dense whole-graph loss — the oracle the engine's gradients are held
    against (``labels`` a tensor or a numpy array)."""
    logits = full_graph_forward(spec, params, x, topo)
    return softmax_xent(logits, torch.as_tensor(labels, device=topo.device))
