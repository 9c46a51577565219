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
:func:`seg_sum` (or :func:`seg_max`), a segment reduction over ``dst`` that
gives the same bits on every run on either device (see their docstrings);
every row gather's backward is the same segment sum over its indices.
Forward and backward are therefore deterministic — the property the
pipelined == serial and kernel == reference checks rest on. The order of
a segment sum: a segment of at most ``SEGMENT_CHUNK`` (256) edges sums
them in edge order, on the CPU and on the card alike; on the card a longer
one sums chunks of ``SEGMENT_CHUNK`` consecutive edges, each in edge
order, and adds the chunk sums in chunk order, where the CPU keeps edge
order throughout.

The six families of the reference (``gcn``, ``sage``, ``gat``, ``gin``,
``pna``, ``graphcast``) are ported with the reference's order of
operations and its guards. Parameter names follow the reference's keys
(``self`` becomes ``lin_self``); ``repro_torch.params`` maps them.

``gcnii`` (Chen et al., ICML 2020) has no counterpart in the reference. Its
convolutions also read a *side input*: the rows of an earlier layer's
activation for the unit's own vertices (``H^0``, layer 1's activation).
:attr:`GNNSpec.side_input` says which layer a module reads so; the engines
stage those rows beside ``ga`` and :func:`apply_vjp` returns their
cotangent as well.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor

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


def _rows(x: torch.Tensor) -> torch.Tensor:
    """The reference's pin of edge / node rows over the batch dims before
    a segment sum: on a ``DTensor`` the rows split over ``DB``, on a plain
    tensor (every step here: the GNN steps work on local shards) ``x``
    itself."""
    if not isinstance(x, DTensor):
        return x
    # here, not at the top: models.lm imports the kernels, which import
    # this module
    from repro_torch.models.lm.sharding import DB, constrain

    return constrain(x, DB, *([None] * (x.dim() - 1)))


def seg_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``out[seg[i]] += x[i]`` over zeros — the counterpart of the
    reference's ``jax.ops.segment_sum``. The same bits on every run on
    either device; no float atomics (``index_add_`` on a CUDA tensor uses
    them, and its order varies from run to run).

    The order. On the CPU, ``index_add_``: each segment in edge order, one
    rounding an edge (a sequential ``np.add.at``). On the card, a float32
    tensor goes to the ``segment_sum`` kernel
    (:func:`repro_torch.kernels.gather_scatter.ops.segment_sum`): a segment
    of at most ``SEGMENT_CHUNK`` (256) edges in edge order too, bitwise
    the CPU's; a longer one in chunks of ``SEGMENT_CHUNK`` consecutive
    edges, each chunk in edge order from zero, the chunk sums added in
    chunk order. Its backward gathers the cotangent's rows. A ``DTensor``
    or another dtype on the card keeps ``index_put_(accumulate=True)``,
    which stable-sorts the indices and sums each segment without atomics
    (in edge order at widths of 32 columns and more; below that its order
    is its own)."""
    x = _rows(x)
    if x.is_cuda and x.dtype == torch.float32 and not isinstance(x, DTensor):
        # here, not at the top: the kernels' plain versions import this
        # module
        from repro_torch.kernels.gather_scatter.ops import segment_sum

        return segment_sum(x.contiguous(), seg.to(torch.int32).contiguous(),
                           n)
    out = x.new_zeros((n,) + tuple(x.shape[1:]))
    if x.is_cuda:
        out.index_put_((seg.long(),), x, accumulate=True)
    else:
        out.index_add_(0, seg, x)
    return out


class _SegMax(torch.autograd.Function):
    """:func:`seg_max` with a backward that keeps no ``(E, d)`` index:
    PyTorch's own ``scatter_reduce`` wants its index in the source's shape
    and saves it (``E * d`` int64, 17 GB for PNA's 2 M x 1024 messages),
    where one row id per edge does."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, seg: torch.Tensor, n: int):
        out = x.new_full((n,) + tuple(x.shape[1:]), float("-inf"))
        if x.shape[0]:
            # a stride-0 view, never materialised
            idx = seg.long().view((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
            out = out.scatter_reduce(0, idx, x, "amax", include_self=False)
        ctx.save_for_backward(x, seg, out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, seg, out = ctx.saved_tensors
        hit = (x == out.index_select(0, seg)).to(x.dtype)
        # tie counts: sums of 0 and 1, exact in any order
        count = torch.zeros_like(out).index_add_(0, seg, hit)
        return (g / count).index_select(0, seg).mul_(hit), None, None


def seg_max(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``out[s] = max(x[i] for seg[i] == s)``, ``-inf`` for an empty
    segment — the counterpart of ``jax.ops.segment_max``.

    ``scatter_reduce(..., "amax", include_self=False)`` over a ``-inf``
    base. Its backward (:class:`_SegMax`, the arithmetic of PyTorch's own)
    splits the cotangent evenly among the tied maxima (``x[i] ==
    out[seg[i]]``) as JAX's does; the tie counts are a sum of ones, exact
    in any order, and the split is gathered back, so the backward has no
    order-dependent float sum. The forward's max is order-free, except that
    a segment holding both ``+0`` and ``-0`` may keep either zero on a CUDA
    device: they compare equal, so the tie counts and every later sum that
    adds a nonzero term keep their bits."""
    return _SegMax.apply(x, seg, n)


def _maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)``: ``torch.maximum`` splits the gradient evenly
    on a tie, as JAX does (``clamp_min`` would pass all of it)."""
    return torch.maximum(x, x.new_full((), c))


def _layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The reference's manual LayerNorm (no affine): mean, biased variance,
    ``rsqrt(var + eps)``, in that order."""
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


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
    """``ga[src]`` (rows of ``ga`` per edge, any trailing shape) with a
    deterministic backward."""
    return _EdgeGather.apply(ga, src)


def _dense(d_in: int, d_out: int, generator: torch.Generator,
           device: DeviceLike, scale: Optional[float] = None) -> nn.Linear:
    """The reference's ``_dense``: weight ``N(0, 1) * scale`` (default
    ``1/sqrt(d_in)``), zero bias. ``skip_init``: no draw from the global
    RNG; the weight is drawn on the CPU from the explicit generator, so
    one seed gives the same weights on every device. On the ``meta``
    device (abstract parameters: shapes only) nothing is drawn."""
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    lin = nn.utils.skip_init(nn.Linear, d_in, d_out, device=device)
    if lin.weight.is_meta:
        return lin
    with torch.no_grad():
        w = torch.randn((d_out, d_in), generator=generator)
        lin.weight.copy_(w * scale)
        lin.bias.zero_()
    return lin


def _param(t: torch.Tensor, device: DeviceLike) -> nn.Parameter:
    return nn.Parameter(t.to(device=device, dtype=torch.float32))


class KinkProbe:
    """Watches the ReLU-family kinks the layer functions evaluate (every
    ``relu`` and ``leaky_relu``, in call order): ``signs[i]`` is call
    ``i``'s ``input > 0``. With ``force`` (such a list, from another run of
    the same forward) call ``i`` takes the branch ``force[i]`` instead of
    its input's sign: ``x`` where True, ``slope * x`` where False. A kink's
    gradient jumps across 0, so where float32 and float64 land on opposite
    sides of it the two gradients differ by that jump; forcing one run onto
    the other's branches removes exactly that difference."""

    def __init__(self, force: Optional[List[torch.Tensor]] = None):
        self.force = force
        self.signs: List[torch.Tensor] = []

    def __call__(self, x: torch.Tensor, slope: float) -> torch.Tensor:
        pos = x.detach() > 0
        branch = pos if self.force is None else self.force[len(self.signs)]
        self.signs.append(pos)
        other = x * slope if slope else x.new_zeros(())
        return torch.where(branch, x, other)


_probe: Optional[KinkProbe] = None


@contextlib.contextmanager
def kink_probe(force: Optional[List[torch.Tensor]] = None
               ) -> Iterator[KinkProbe]:
    """Route every kink of the layer functions through a
    :class:`KinkProbe` while the block runs (one thread: the dense
    oracle's)."""
    global _probe
    _probe = KinkProbe(force)
    try:
        yield _probe
    finally:
        _probe = None


def _relu(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x) if _probe is None else _probe(x, 0.0)


def _leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``: ``where(x >= 0, x, slope * x)``, whose
    gradient at exactly 0 is 1 (``F.leaky_relu``'s is ``slope``; a GAT
    score is exactly 0 where both endpoint rows are zero)."""
    if _probe is None:
        return torch.where(x >= 0, x, x * slope)
    return _probe(x, slope)


def _out(h: torch.Tensor, activate: bool) -> torch.Tensor:
    return _relu(h) if activate else h


def apply_with(apply: Callable, layer: nn.Module, ga: torch.Tensor,
               topo: "LocalTopo", activate: bool,
               side: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``apply(layer, ga, topo, activate)``, handing the layer its side
    input where it reads one (:attr:`GNNSpec.side_input`)."""
    if side is None:
        return apply(layer, ga, topo, activate=activate)
    return apply(layer, ga, topo, activate=activate, side=side)


def apply_vjp(apply: Callable, layer: nn.Module, ga: torch.Tensor,
              topo: "LocalTopo", d_out: torch.Tensor, activate: bool,
              side: Optional[torch.Tensor] = None):
    """vjp of one layer at ``ga``: ``({param_name: dL/dparam}, dL/dga)``
    for the cotangent ``d_out`` of ``apply(layer, ga, topo, activate)``;
    with a ``side`` input, ``(..., dL/dside)`` as a third element.
    Recomputes the layer's intermediates (the regather engine keeps none)
    under ``enable_grad`` — the forward runner computes under ``no_grad``."""
    names, params = zip(*layer.named_parameters())
    ga = ga.detach().requires_grad_(True)
    inputs = [*params, ga]
    if side is not None:
        side = side.detach().requires_grad_(True)
        inputs.append(side)
    with torch.enable_grad():
        out = apply_with(apply, layer, ga, topo, activate, side)
        grads = torch.autograd.grad(out, inputs, d_out)
    dp = dict(zip(names, grads[:len(names)]))
    return (dp, *grads[len(names):])


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
        self.lin = _dense(d_in, d_out, generator, device)


def gcn_aggregate(ga: torch.Tensor, topo: LocalTopo) -> torch.Tensor:
    """``P̃ ga`` over the unit's edges: gather, scale by ``edge_weight``,
    segment sum over ``dst``. The scale is applied in place on the freshly
    gathered messages (same single rounding, one ``(E, d)`` tensor live
    instead of two)."""
    msg = edge_gather(ga, topo.src)
    msg.mul_(topo.edge_weight[:, None])
    return seg_sum(msg, topo.dst, topo.n_dst)


def gcn_apply(layer: GCNLayer, ga: torch.Tensor, topo: LocalTopo,
              activate: bool = True) -> torch.Tensor:
    """:func:`gcn_aggregate`, dense, relu — the reference ``gcn_apply``'s
    order."""
    return _out(layer.lin(gcn_aggregate(ga, topo)), activate)


def gcn_fused_forward(kd: Any, layer: GCNLayer, stack: torch.Tensor,
                      idx: torch.Tensor, topo: LocalTopo,
                      activate: bool = True) -> torch.Tensor:
    """GCN's ``kernel-fused`` forward over the staged partition stack: the
    dispatcher ``kd``'s one-kernel ``gather_aggregate`` in place of the
    gather, scale and segment sum. Only the real-edge prefix goes to the
    kernel: the padding tail (weight 0) would add exactly +0 to a sum that
    is never -0, so dropping it leaves the bits unchanged and keeps ``dst``
    sorted (the reference re-points the padding at the last row instead,
    whose block would then walk up to half of ``e_pad`` zero edges)."""
    e = topo.n_real_edges
    agg = kd.gather_aggregate(stack, idx.index_select(0, topo.src[:e]),
                              topo.dst[:e], topo.edge_weight[:e], topo.n_dst)
    return _out(layer.lin(agg), activate)


# --------------------------------------------------------------------------
# GCNII (Chen et al., "Simple and Deep Graph Convolutional Networks", ICML
# 2020, eq. 5): a dense input layer makes H^0, every convolution mixes its
# aggregate with H^0 (the initial residual) and its own input into its
# weight (the identity mapping), a dense output layer makes the logits.
# --------------------------------------------------------------------------

GCNII_ALPHA = 0.1     # the initial residual's share (the authors' default)
GCNII_LAMBDA = 0.4    # beta_l = ln(lambda / l + 1) (their Pubmed setting)


def gcnii_beta(index: int, lam: float = GCNII_LAMBDA) -> float:
    """The identity mapping's weight of convolution ``index`` (1-based,
    the module index): ``ln(lambda / index + 1)``."""
    return math.log(lam / index + 1.0)


class GCNIIDense(nn.Module):
    """GCNII's input (``d_feat -> d_hidden``) or output layer: ``lin`` on
    each vertex's own row, no aggregation."""

    def __init__(self, d_in: int, d_out: int, *, generator: torch.Generator,
                 device: DeviceLike = None):
        super().__init__()
        self.lin = _dense(d_in, d_out, generator, device)


class GCNIIConv(nn.Module):
    """One GCNII convolution: weight ``w`` ``(d, d)`` (N(0, 1) / sqrt(d), no
    bias, as the authors' layers). ``alpha`` and ``beta`` are plain floats
    of the module index, not buffers: a layer built on the meta device and
    materialised with ``to_empty`` keeps them."""

    def __init__(self, d: int, *, index: int, generator: torch.Generator,
                 device: DeviceLike = None, alpha: float = GCNII_ALPHA,
                 lam: float = GCNII_LAMBDA):
        super().__init__()
        self.w = _param(torch.randn((d, d), generator=generator)
                        / np.sqrt(d), device)
        self.alpha = alpha
        self.beta = gcnii_beta(index, lam)


def gcnii_layer(d_in: int, d_out: int, *, generator: torch.Generator,
                device: DeviceLike = None, index: int,
                n_layers: int) -> nn.Module:
    """Module ``index`` of ``n_layers``: dense first and last, a
    convolution (``d_in == d_out``) between."""
    if index in (0, n_layers - 1):
        return GCNIIDense(d_in, d_out, generator=generator, device=device)
    if d_in != d_out:
        raise ValueError(f"GCNII convolution {index}: width {d_in} -> "
                         f"{d_out}; its convolutions keep the width")
    return GCNIIConv(d_in, index=index, generator=generator, device=device)


def gcnii_side_input(index: int, n_layers: int) -> Optional[int]:
    """Every convolution reads ``H^0``, layer 1's activation (the dense
    input layer's output)."""
    return 1 if 0 < index < n_layers - 1 else None


def gcnii_apply(layer: nn.Module, ga: torch.Tensor, topo: LocalTopo,
                activate: bool = True,
                side: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A convolution: ``s = (1 - alpha) P̃ ga + alpha side`` (``side`` =
    ``H^0``'s rows of the unit's vertices), then ``(1 - beta) s + beta s
    w`` in one ``addmm``; a dense layer: ``lin`` on each vertex's own row
    of ``ga``. Then relu where ``activate``."""
    if isinstance(layer, GCNIIConv):
        if side is None:
            raise ValueError("a GCNII convolution reads H^0: pass side=")
        s = (1.0 - layer.alpha) * gcn_aggregate(ga, topo) \
            + layer.alpha * side
        out = torch.addmm(s, s, layer.w, beta=1.0 - layer.beta,
                          alpha=layer.beta)
    else:
        out = layer.lin(edge_gather(ga, topo.dst_self))
    return _out(out, activate)


# --------------------------------------------------------------------------
# GraphSAGE (mean aggregator)
# --------------------------------------------------------------------------

class SAGELayer(nn.Module):
    """``lin_self`` (the reference's ``self``) on the vertex's own row,
    ``nbr`` on the mean of its in-neighbours."""

    def __init__(self, d_in: int, d_out: int, *, generator: torch.Generator,
                 device: DeviceLike = None):
        super().__init__()
        self.lin_self = _dense(d_in, d_out, generator, device)
        self.nbr = _dense(d_in, d_out, generator, device)


def sage_apply(layer: SAGELayer, ga: torch.Tensor, topo: LocalTopo,
               activate: bool = True) -> torch.Tensor:
    msg = edge_gather(ga, topo.src)
    msg.mul_(topo.edge_mask[:, None])
    agg = seg_sum(msg, topo.dst, topo.n_dst) / topo.in_deg[:, None]
    del msg
    x_self = edge_gather(ga, topo.dst_self)
    return _out(layer.lin_self(x_self) + layer.nbr(agg), activate)


# --------------------------------------------------------------------------
# GAT (single-/multi-head graph attention)
# --------------------------------------------------------------------------

class GATLayer(nn.Module):
    """``w`` ``(d_in, H, d_head)``, ``a_src``/``a_dst`` ``(H, d_head)``,
    ``b`` ``(H * d_head,)`` — the reference's layout. ``n_heads`` heads, or
    one where ``d_out % n_heads != 0``."""

    def __init__(self, d_in: int, d_out: int, *, generator: torch.Generator,
                 device: DeviceLike = None, n_heads: int = 4):
        super().__init__()
        if d_out % n_heads:
            n_heads = 1
        d_head = d_out // n_heads
        g = generator
        self.w = _param(torch.randn((d_in, n_heads, d_head), generator=g)
                        / np.sqrt(d_in), device)
        self.a_src = _param(
            torch.randn((n_heads, d_head), generator=g) * 0.1, device)
        self.a_dst = _param(
            torch.randn((n_heads, d_head), generator=g) * 0.1, device)
        self.b = _param(torch.zeros((n_heads * d_head,)), device)


def gat_softmax(score: torch.Tensor, topo: LocalTopo) -> torch.Tensor:
    """The reference's per-destination attention softmax over ``score``
    ``(E, H)``, padding included: padded edges are masked to
    ``finfo.min``, the segment max is floored at ``-1e30`` (an all-padding
    segment), the exponentials are masked and the denominator clamped at
    ``1e-9``. Padded edges get attention 0."""
    mask = topo.edge_mask[:, None]
    score = torch.where(mask > 0, score, torch.finfo(score.dtype).min)
    smax = _maximum(seg_max(score, topo.dst, topo.n_dst), -1e30)
    ex = torch.exp(score - edge_gather(smax, topo.dst)) * mask
    den = seg_sum(ex, topo.dst, topo.n_dst)
    return ex / _maximum(edge_gather(den, topo.dst), 1e-9)


def gat_apply(layer: GATLayer, ga: torch.Tensor, topo: LocalTopo,
              activate: bool = True,
              softmax: Callable[[torch.Tensor, LocalTopo],
                                torch.Tensor] = gat_softmax) -> torch.Tensor:
    """``softmax(score, topo) -> attn`` normalises the ``(E, H)`` scores
    per destination: :func:`gat_softmax` by default; the kernel dispatcher
    passes the ``edge_softmax`` kernel in its ``kernel-fused`` mode."""
    d_in, n_heads, d_head = layer.w.shape
    h = (ga @ layer.w.reshape(d_in, n_heads * d_head)).reshape(
        -1, n_heads, d_head)                                  # (n_src, H, dh)
    e_src = torch.einsum("nhe,he->nh", h, layer.a_src)
    e_dst = torch.einsum("nhe,he->nh", h, layer.a_dst)
    score = _leaky_relu(
        edge_gather(e_src, topo.src)
        + edge_gather(edge_gather(e_dst, topo.dst_self), topo.dst),
        0.2,
    )                                                         # (E, H)
    attn = softmax(score, topo)
    msg = edge_gather(h, topo.src) * attn[:, :, None]
    agg = seg_sum(msg, topo.dst, topo.n_dst)                  # (n_dst, H, dh)
    del msg
    out = agg.reshape(topo.n_dst, -1) + layer.b
    return torch.nn.functional.elu(out) if activate else out


def gat_fused_apply(kd: Any) -> Callable[..., torch.Tensor]:
    """GAT's ``kernel-fused`` layer function: :func:`gat_apply` with the
    dispatcher ``kd``'s ``edge_softmax`` kernel as its softmax."""
    return partial(gat_apply, softmax=kd.edge_softmax)


# --------------------------------------------------------------------------
# GIN
# --------------------------------------------------------------------------

class GINLayer(nn.Module):
    """Two dense layers and the 0-d learnable ``eps``."""

    def __init__(self, d_in: int, d_out: int, *, generator: torch.Generator,
                 device: DeviceLike = None):
        super().__init__()
        self.mlp1 = _dense(d_in, d_out, generator, device)
        self.mlp2 = _dense(d_out, d_out, generator, device)
        self.eps = _param(torch.zeros(()), device)


def gin_apply(layer: GINLayer, ga: torch.Tensor, topo: LocalTopo,
              activate: bool = True) -> torch.Tensor:
    msg = edge_gather(ga, topo.src)
    msg.mul_(topo.edge_mask[:, None])
    agg = seg_sum(msg, topo.dst, topo.n_dst)
    del msg
    x = (1.0 + layer.eps) * edge_gather(ga, topo.dst_self) + agg
    # the reference's stateless LayerNorm in place of GIN's BatchNorm
    h = _layernorm(_relu(layer.mlp1(x)))
    return _out(layer.mlp2(h), activate)


# --------------------------------------------------------------------------
# PNA — mean/max/min/std aggregators × identity/amplification/attenuation
# --------------------------------------------------------------------------

class PNALayer(nn.Module):
    """``pre`` on every source row, ``post`` on the 12 scaled aggregates
    and the vertex's own row, and the 0-d ``log_mean_deg`` (1.0, as the
    reference initialises it)."""

    def __init__(self, d_in: int, d_out: int, *, generator: torch.Generator,
                 device: DeviceLike = None):
        super().__init__()
        self.pre = _dense(d_in, d_in, generator, device)
        self.post = _dense(12 * d_in + d_in, d_out, generator, device)
        self.log_mean_deg = _param(torch.tensor(1.0), device)


def pna_apply(layer: PNALayer, ga: torch.Tensor, topo: LocalTopo,
              activate: bool = True) -> torch.Tensor:
    mask = topo.edge_mask[:, None]
    msg = edge_gather(_relu(layer.pre(ga)), topo.src) * mask
    n = topo.n_dst
    deg = topo.in_deg[:, None]
    mean = seg_sum(msg, topo.dst, n) / deg
    neg = torch.finfo(msg.dtype).min
    real = mask > 0
    mx = _maximum(seg_max(torch.where(real, msg, neg), topo.dst, n), -1e30)
    mn = -_maximum(seg_max(-torch.where(real, msg, -neg), topo.dst, n),
                   -1e30)
    sq = seg_sum(msg * msg, topo.dst, n) / deg
    del msg
    std = torch.sqrt(_maximum(sq - mean * mean, 0.0) + 1e-5)
    aggs = torch.cat([mean, mx, mn, std], dim=-1)             # (n, 4d)
    logd = torch.log(deg + 1.0)
    amp = logd / layer.log_mean_deg
    att = layer.log_mean_deg / _maximum(logd, 1e-5)
    scaled = torch.cat([aggs, aggs * amp, aggs * att], dim=-1)  # (n, 12d)
    x = torch.cat([scaled, edge_gather(ga, topo.dst_self)], dim=-1)
    return _out(layer.post(x), activate)


# --------------------------------------------------------------------------
# GraphCast-style processor layer (interaction network, node-centric
# variant): edge latents are recomputed from endpoint features each layer,
# as in the reference; residual ``proj`` as in the processor.
# --------------------------------------------------------------------------

class GraphCastLayer(nn.Module):
    """Edge MLP ``edge1``/``edge2``, node MLP ``node1``/``node2`` and the
    residual projection ``proj``."""

    def __init__(self, d_in: int, d_out: int, *, generator: torch.Generator,
                 device: DeviceLike = None):
        super().__init__()
        d = d_out
        self.edge1 = _dense(2 * d_in, d, generator, device)
        self.edge2 = _dense(d, d, generator, device)
        self.node1 = _dense(d_in + d, d, generator, device)
        self.node2 = _dense(d, d, generator, device)
        self.proj = _dense(d_in, d, generator, device)


def graphcast_apply(layer: GraphCastLayer, ga: torch.Tensor,
                    topo: LocalTopo, activate: bool = True) -> torch.Tensor:
    silu = torch.nn.functional.silu
    x_self = edge_gather(ga, topo.dst_self)
    e = torch.cat([edge_gather(ga, topo.src),
                   edge_gather(x_self, topo.dst)], dim=-1)
    e = silu(layer.edge1(e))
    # LayerNorm after every MLP, as GraphCast does
    e = _layernorm(layer.edge2(e)) * topo.edge_mask[:, None]
    agg = seg_sum(e, topo.dst, topo.n_dst)
    del e
    h = silu(layer.node1(torch.cat([x_self, agg], dim=-1)))
    h = _layernorm(layer.node2(h))
    h = h + layer.proj(x_self)  # residual
    return _out(h, activate)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GNNSpec:
    """A family's layer class and layer function, and its variants for the
    dispatcher's ``kernel-fused`` mode (None: the plain ones):
    ``fused_forward(kd, layer, stack, idx, topo, activate)`` replaces the
    stacked forward's regather + ``apply_layer``; ``fused_apply(kd)``
    returns the layer function the stacked forward and backward run.

    ``indexed``: ``layer_cls`` also takes the module's ``index`` and
    ``n_layers`` (its modules differ by index). ``side_input(index,
    n_layers)``: the activation layer whose rows of the unit's own vertices
    module ``index`` reads beside ``ga`` (passed as ``side=``), or None."""

    name: str
    layer_cls: Callable[..., nn.Module]
    apply_layer: Callable[..., torch.Tensor]
    fused_forward: Optional[Callable[..., torch.Tensor]] = None
    fused_apply: Optional[Callable[[Any], Callable[..., torch.Tensor]]] = None
    indexed: bool = False
    side_input: Optional[Callable[[int, int], Optional[int]]] = None

    def side_layer(self, index: int, n_layers: int) -> Optional[int]:
        """:attr:`side_input` of module ``index`` (None for a family
        without one)."""
        if self.side_input is None:
            return None
        return self.side_input(index, n_layers)

    def init(self, generator: torch.Generator, d_in: int, d_hidden: int,
             d_out: int, n_layers: int,
             device: DeviceLike = None) -> nn.ModuleList:
        device = resolve_device(device)
        dims = [d_in] + [d_hidden] * (n_layers - 1) + [d_out]
        return nn.ModuleList(
            self.layer_cls(dims[i], dims[i + 1], device=device,
                           generator=generator,
                           **(dict(index=i, n_layers=n_layers)
                              if self.indexed else {}))
            for i in range(n_layers)
        )


GNN_REGISTRY: Dict[str, GNNSpec] = {
    "gcn": GNNSpec("gcn", GCNLayer, gcn_apply,
                   fused_forward=gcn_fused_forward),
    "sage": GNNSpec("sage", SAGELayer, sage_apply),
    "gat": GNNSpec("gat", GATLayer, gat_apply, fused_apply=gat_fused_apply),
    "gin": GNNSpec("gin", GINLayer, gin_apply),
    "pna": GNNSpec("pna", PNALayer, pna_apply),
    "graphcast": GNNSpec("graphcast", GraphCastLayer, graphcast_apply),
    "gcnii": GNNSpec("gcnii", gcnii_layer, gcnii_apply, indexed=True,
                     side_input=gcnii_side_input),
}


def get_gnn(name: str) -> GNNSpec:
    if name not in GNN_REGISTRY:
        raise KeyError(
            f"GNN model {name!r} is not ported (ported: "
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
    n = len(params)
    sides = [spec.side_layer(i, n) for i in range(n)]
    kept = {}      # the activations a later module reads as its side input
    for i, layer in enumerate(params):
        if i in sides:
            kept[i] = h
        h = apply_with(spec.apply_layer, layer, h, topo, i < n - 1,
                       kept.get(sides[i]))
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
