"""Distributed GNN training steps over ``torch.distributed`` (the
reference's ``distributed/gnn_parallel.py``).

1. :func:`make_fullgraph_train_step`, the CAGNET-style baseline (Tripathy
   et al., SC'20), the paper's distributed baseline: node rows are
   row-sharded over the data group, every layer all-gathers the activations
   ``h``, each rank aggregates into the rows it owns (it holds the edges
   whose destination is one of them), and the parameter gradients are
   summed over the ranks. The step computes the same global function as on
   one rank.
2. :func:`make_partitioned_train_step`, the partitioned-halo step: nodes
   renumbered partition-contiguously (one partition a rank), edges split
   into intra-partition edges and halo edges whose source rows each rank
   picks out of an all-gather of the layer's rows (``halo_idx``).
3. :func:`make_mfg_train_step` / :func:`make_batched_graph_train_step`,
   data-parallel sampled-MFG and batched-small-graph training: the groups
   (or graphs) of a rank run as one block-diagonal graph, their ids offset
   per group, and the gradients are averaged over the ranks.

Each step is a per-rank function: it takes its rank's shard of every
argument (the ``*_inputs`` functions give the global shapes and their
placements) and returns ``(params, opt_state, loss)`` after the port's
``adamw_update``, with the same loss on every rank. Steps run on ``nccl``
on the card and on ``gloo`` on the CPU; ``group`` is the data group
(default: the whole world). Message passing is the layers' own
``edge_gather`` / ``seg_sum``, whose sums on the card are the
``segment_sum`` kernel; no step launches another kernel of
``repro_torch.kernels``.

A zero edge weight marks a padding edge: the steps take ``edge_mask =
edge_weight != 0`` (the reference's halo step does the same; its
full-graph step takes a mask of ones, the same thing where no edge is
padding).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import axis_size, data_axes
from repro_torch.models.gnn.layers import (
    LocalTopo, edge_gather, get_gnn, softmax_xent,
)
from repro_torch.optim.adamw import adamw_update


# --------------------------------------------------------------------------
# collectives under autograd
# --------------------------------------------------------------------------

class _AllGatherRows(torch.autograd.Function):
    """Every rank's rows of ``h``, stacked in rank order. Backward: the
    cotangent summed over the ranks, each rank keeping its own rows (the
    transpose of an all-gather is a reduce-scatter)."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        w = dist.get_world_size(group)
        out = h.new_empty((w * h.shape[0],) + tuple(h.shape[1:]))
        dist.all_gather_into_tensor(out, h.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        w = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // w,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        return out, None


def all_gather_rows(h: torch.Tensor, group=None) -> torch.Tensor:
    """``(world * n, ...)``: every rank's ``(n, ...)`` rows in rank order,
    differentiable."""
    return _AllGatherRows.apply(h, group or dist.group.WORLD)


def _all_reduce(tensors: List[torch.Tensor], group, mean: bool
                ) -> List[torch.Tensor]:
    """The ranks' sum (or mean) of each tensor, in one flat all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    if mean:
        flat /= dist.get_world_size(group)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def _grads(loss: torch.Tensor, params) -> List[torch.Tensor]:
    """d loss / d each parameter in ``state_dict`` order; zeros for a
    parameter the loss does not reach (as JAX's gradient has them)."""
    ps = list(params.parameters())
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(ps, gs)]


def _update(params, opt_state, loss, grads, group, mean: bool, lr: float):
    """Reduce ``loss`` and ``grads`` over ``group`` (sum, or mean), then
    one AdamW step."""
    *grads, loss = _all_reduce(grads + [loss.detach().reshape(1)], group,
                               mean)
    params2, opt_state2 = adamw_update(grads, params, opt_state, lr=lr)
    return params2, opt_state2, loss[0]


def _loss(logits: torch.Tensor, labels: torch.Tensor, loss_kind: str,
          n_total: Optional[int] = None) -> torch.Tensor:
    """Mean cross-entropy (or mean squared error) over ``n_total`` rows
    (default: the rows of ``logits``), as a sum over these rows divided by
    the total, so that row shards add up to the whole."""
    n_total = n_total if n_total is not None else logits.shape[0]
    if loss_kind == "mse":
        return ((logits - labels) ** 2).sum() / (n_total * logits.shape[1])
    return softmax_xent(logits, labels, n_total=n_total)


def _mask(ew: torch.Tensor) -> torch.Tensor:
    return (ew != 0).to(ew.dtype)


def _rows(mesh, axes=None) -> Tuple:
    """One placement per mesh dim: ``Shard(0)`` on ``axes`` (default: the
    data dims), ``Replicate()`` on the others."""
    axes = data_axes(mesh) if axes is None else axes
    return tuple(Shard(0) if a in axes else Replicate()
                 for a in mesh.mesh_dim_names)


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _labels(shape_rows: Tuple[int, ...], d_out: int, loss_kind: str):
    if loss_kind == "mse":
        return _meta(shape_rows + (d_out,))
    return _meta(shape_rows, torch.int32)


# --------------------------------------------------------------------------
# 1. CAGNET-style full-graph step (baseline)
# --------------------------------------------------------------------------

def make_fullgraph_train_step(
    model: str, n_nodes: int, loss_kind: str = "ce", lr: float = 1e-3,
    sharded: bool = True, remat: bool = True, group=None,
):
    """CAGNET-style full-graph step over ``n_nodes`` (padded) rows.

    ``train_step(params, opt_state, x, src, dst, ew, deg, labels)`` takes
    the rank's row block of ``x``, ``deg`` and ``labels`` (``n_nodes /
    world`` rows each, rank order) and the edges into those rows (``src``
    and ``dst`` global row ids, a zero ``ew`` marking padding;
    :func:`fullgraph_shards` splits a graph so). Each layer all-gathers
    ``h``; the loss is the mean over all ``n_nodes`` rows, padding rows
    included, as the reference's ``softmax_xent``. ``remat`` recomputes
    each layer in the backward (``torch.utils.checkpoint``, non-reentrant)
    instead of keeping its ``(E, d)`` messages. ``sharded=False``: every
    rank all-gathers the inputs and computes the whole graph itself (the
    reference's unconstrained variant); on one rank both are the same.

    At ``ogb_products`` size on one 80 GB card the backward holds two
    ``(E, 128)`` float32 tensors (31.7 GB each) at once: run it with the
    caching allocator's ``expandable_segments:True``
    (``PYTORCH_CUDA_ALLOC_CONF``), or the forward's smaller tensors split
    the free memory into pieces too small for them."""
    spec = get_gnn(model)

    def train_step(params, opt_state, x, src, dst, ew, deg, labels):
        grp = group or dist.group.WORLD
        rank = dist.get_rank(grp)
        if not sharded:
            x, src, dst, ew, deg, labels = (
                all_gather_rows(t, grp)
                for t in (x, src, dst, ew, deg, labels))
            rank = 0
        n_loc = x.shape[0]
        row0 = rank * n_loc
        topo = LocalTopo(
            src=src, dst=dst - row0, n_dst=n_loc, edge_weight=ew,
            edge_mask=_mask(ew), in_deg=deg,
            dst_self=torch.arange(row0, row0 + n_loc, dtype=torch.int32,
                                  device=x.device),
            n_real_edges=src.shape[0],
        )
        n_layers = len(params)
        with torch.enable_grad():
            h = x
            for i, layer in enumerate(params):
                def apply(h_all, layer=layer, act=(i < n_layers - 1)):
                    return spec.apply_layer(layer, h_all, topo, activate=act)

                h_all = all_gather_rows(h, grp) if sharded else h
                h = (checkpoint(apply, h_all, use_reentrant=False)
                     if remat else apply(h_all))
            loss = _loss(h, labels, loss_kind, n_total=n_nodes)
            grads = _grads(loss, params)
        if not sharded:   # every rank computed the whole loss
            return (*adamw_update(grads, params, opt_state, lr=lr),
                    loss.detach())
        return _update(params, opt_state, loss, grads, grp, False, lr)

    return train_step


def fullgraph_inputs(
    n_nodes: int, n_edges: int, d_feat: int, d_out: int, mesh,
    loss_kind: str = "ce",
):
    """Abstract arguments of the full-graph step and their placements:
    rows and edges padded to a multiple of the data ranks, every argument
    ``Shard(0)`` over the data dims (edges balanced, as the reference
    assumes; :func:`fullgraph_shards` pads to the busiest rank)."""
    nd = axis_size(mesh, data_axes(mesh))
    n_pad = ((n_nodes + nd - 1) // nd) * nd
    e_pad = ((n_edges + nd - 1) // nd) * nd
    args = (
        _meta((n_pad, d_feat)),
        _meta((e_pad,), torch.int32),
        _meta((e_pad,), torch.int32),
        _meta((e_pad,)),
        _meta((n_pad,)),
        _labels((n_pad,), d_out, loss_kind),
    )
    row = _rows(mesh)
    return n_pad, args, tuple(row for _ in args)


def fullgraph_shards(n_pad: int, src: np.ndarray, dst: np.ndarray,
                     ew: np.ndarray, world: int):
    """Split a graph's edges among ``world`` row-block owners (rank ``r``
    owns rows ``[r * n_pad / world, (r + 1) * n_pad / world)`` and the
    edges into them), each rank's ``(src, dst, ew)`` padded to the busiest
    rank's count with ``(0, its first row, 0.0)``."""
    n_loc = n_pad // world
    owner = np.asarray(dst, np.int64) // n_loc
    per = [np.flatnonzero(owner == r) for r in range(world)]
    e_loc = max(max(len(p) for p in per), 1)
    out = []
    for r, idx in enumerate(per):
        s = np.zeros(e_loc, np.int32)
        d = np.full(e_loc, r * n_loc, np.int32)
        w = np.zeros(e_loc, np.float32)
        s[:len(idx)], d[:len(idx)], w[:len(idx)] = src[idx], dst[idx], ew[idx]
        out.append((s, d, w))
    return out


# --------------------------------------------------------------------------
# 2. Partitioned-halo full-graph step
# --------------------------------------------------------------------------

def make_partitioned_train_step(
    model: str, n_local: int, n_halo: int, mesh, axis: str = "data",
    loss_kind: str = "ce", lr: float = 1e-3,
):
    """Partitioned full-graph step over the ``axis`` group of ``mesh``:
    ``train_step(params, opt_state, x, lsrc, ldst, lew, hsrc, hdst, hew,
    halo_idx, deg, labels)`` takes the rank's partition (``x`` its
    ``n_local`` rows; ``halo_idx`` its ``n_halo`` halo rows' positions in
    the all-gathered ``(world * n_local)`` rows; local edges index its own
    rows, halo edges the halo rows), as :func:`build_partitioned_data`
    lays them out. Each layer all-gathers ``h`` and picks the halo rows;
    the loss is the mean over the rank's rows, and loss and gradients are
    averaged over the ranks before AdamW."""
    spec = get_gnn(model)
    group = mesh.get_group(axis)

    def train_step(params, opt_state, x, lsrc, ldst, lew, hsrc, hdst, hew,
                   halo_idx, deg, labels):
        ew = torch.cat([lew, hew])
        topo = LocalTopo(
            src=torch.cat([lsrc, hsrc + n_local]),
            dst=torch.cat([ldst, hdst]), n_dst=n_local, edge_weight=ew,
            edge_mask=_mask(ew), in_deg=deg,
            dst_self=torch.arange(n_local, dtype=torch.int32,
                                  device=x.device),
            n_real_edges=ew.shape[0],
        )
        n_layers = len(params)
        with torch.enable_grad():
            h = x
            for i, layer in enumerate(params):
                # boundary exchange: the halo rows of every rank's rows
                h_halo = edge_gather(all_gather_rows(h, group), halo_idx)
                h = spec.apply_layer(layer, torch.cat([h, h_halo]), topo,
                                     activate=(i < n_layers - 1))
            loss = _loss(h, labels, loss_kind)
            grads = _grads(loss, params)
        return _update(params, opt_state, loss, grads, group, True, lr)

    return train_step


def partitioned_inputs(
    n_nodes: int, n_edges: int, d_feat: int, d_out: int, mesh,
    alpha: float = 4.0, axis: str = "data", loss_kind: str = "ce",
):
    """Abstract arguments of the partitioned-halo step: the halo size from
    the partitioner's expansion ratio ``alpha``, an 85 / 15 split of each
    partition's edges into local and halo edges (the reference's
    estimate). Returns ``(n_local, n_halo, args, placements)``."""
    nshards = mesh.size(mesh.mesh_dim_names.index(axis))
    n_local = (n_nodes + nshards - 1) // nshards
    n_local = ((n_local + 7) // 8) * 8
    e_local = int(n_edges / nshards * 0.85) // 8 * 8 + 8
    e_halo = int(n_edges / nshards * 0.15) // 8 * 8 + 8
    n_halo = min(
        int(n_local * max(alpha - 1.0, 0.1)), n_nodes - 1
    ) // 8 * 8 + 8
    G = nshards
    args = (
        _meta((G * n_local, d_feat)),          # x
        _meta((G * e_local,), torch.int32),    # lsrc
        _meta((G * e_local,), torch.int32),    # ldst
        _meta((G * e_local,)),                 # lew
        _meta((G * e_halo,), torch.int32),     # hsrc
        _meta((G * e_halo,), torch.int32),     # hdst
        _meta((G * e_halo,)),                  # hew
        _meta((G * n_halo,), torch.int32),     # halo_idx
        _meta((G * n_local,)),                 # deg
        _labels((G * n_local,), d_out, loss_kind),
    )
    row = _rows(mesh, (axis,))
    return n_local, n_halo, args, tuple(row for _ in args)


def build_partitioned_data(
    g, parts: np.ndarray, n_parts: int,
    edge_weight: Optional[np.ndarray] = None,
):
    """Concrete inputs of :func:`make_partitioned_train_step` (numpy).

    Reorders the graph partition-contiguously, splits each partition's
    edges into local and halo edges, pads to uniform per-partition sizes.
    Returns ``(data, n_local, n_halo, reorder)``: ``data`` maps ``lsrc``,
    ``ldst``, ``lew``, ``hsrc``, ``hdst``, ``hew``, ``halo`` and ``deg`` to
    ``(n_parts, size)`` arrays, row ``p`` partition ``p``'s."""
    from repro_torch.core.plan import remap_edge_weight
    from repro_torch.graph.reorder import reorder_by_partition

    ro = reorder_by_partition(g, parts, n_parts)
    rg = ro.graph
    if edge_weight is None:
        ew_full = np.ones(rg.n_edges, np.float32)
    else:
        # edge_weight arrives in the ORIGINAL graph's CSR edge order
        ew_full = remap_edge_weight(g, ro, edge_weight)
    sizes = np.diff(ro.part_ptr)
    n_local = int(sizes.max())
    per = []
    for p in range(n_parts):
        v0, v1 = ro.partition_slice(p)
        e0, e1 = int(rg.indptr[v0]), int(rg.indptr[v1])
        src = rg.indices[e0:e1].astype(np.int64)
        dst = (
            np.repeat(np.arange(v0, v1), np.diff(rg.indptr[v0:v1 + 1])) - v0
        ).astype(np.int64)
        ew = ew_full[e0:e1]
        local_mask = (src >= v0) & (src < v1)
        halo, hsrc = np.unique(src[~local_mask], return_inverse=True)
        # global row in the all-gathered (n_parts * n_local) array
        halo_part = ro.parts[halo]
        halo_rows = halo_part.astype(np.int64) * n_local + (
            halo - ro.part_ptr[halo_part]
        )
        per.append(dict(
            lsrc=(src[local_mask] - v0).astype(np.int32),
            ldst=dst[local_mask].astype(np.int32), lew=ew[local_mask],
            hsrc=hsrc.astype(np.int32),
            hdst=dst[~local_mask].astype(np.int32), hew=ew[~local_mask],
            halo=halo_rows.astype(np.int32),
            deg=np.maximum(np.diff(rg.indptr[v0:v1 + 1]),
                           1).astype(np.float32),
        ))
    e_local = max(max(len(d["lsrc"]) for d in per), 1)
    e_halo = max(max(len(d["hsrc"]) for d in per), 1)
    n_halo = max(max(len(d["halo"]) for d in per), 1)

    def padded(key, size, dtype, fill=0):
        out = np.full((n_parts, size), fill, dtype)
        for i, d in enumerate(per):
            out[i, : len(d[key])] = d[key]
        return out

    data = dict(
        lsrc=padded("lsrc", e_local, np.int32),
        ldst=padded("ldst", e_local, np.int32),
        lew=padded("lew", e_local, np.float32, 0.0),
        hsrc=padded("hsrc", e_halo, np.int32),
        hdst=padded("hdst", e_halo, np.int32),
        hew=padded("hew", e_halo, np.float32, 0.0),
        halo=padded("halo", n_halo, np.int32),
        deg=padded("deg", n_local, np.float32, 1.0),
    )
    return data, n_local, n_halo, ro


# --------------------------------------------------------------------------
# 3. Data-parallel sampled-MFG / batched-graph steps
# --------------------------------------------------------------------------

def _block_topo(src, dst, mask, deg, n_src: int, n_dst: int) -> LocalTopo:
    """``G`` graphs of ``(G, E)`` edges over ``n_src`` source and ``n_dst``
    destination rows each, as one block-diagonal graph: graph ``g``'s
    source rows at ``g * n_src``, its destinations at ``g * n_dst``, its
    destination vertices the first ``n_dst`` of its source rows."""
    G = src.shape[0]
    g = torch.arange(G, dtype=torch.int32, device=src.device)[:, None]
    dst_self = g * n_src + torch.arange(n_dst, dtype=torch.int32,
                                        device=src.device)
    m = mask.reshape(-1)
    return LocalTopo(
        src=(src + g * n_src).reshape(-1), dst=(dst + g * n_dst).reshape(-1),
        n_dst=G * n_dst, edge_weight=m, edge_mask=m, in_deg=deg.reshape(-1),
        dst_self=dst_self.reshape(-1), n_real_edges=m.shape[0],
    )


def make_mfg_train_step(
    model: str, hop_sizes: Sequence[tuple], loss_kind: str = "ce",
    lr: float = 1e-3, group=None,
):
    """Data-parallel sampled training: ``train_step(params, opt_state,
    x_in, hops_flat, labels)`` with a leading group axis on every argument
    (``x_in`` ``(G, n_src_0, d)``; ``hops_flat[i]`` = ``(src, dst, mask,
    deg)`` of hop ``i``, innermost first, ``(G, n_edges_i)`` /
    ``(G, n_dst_i)``; ``labels`` ``(G, n_seed)``). The rank's groups run
    as one block-diagonal graph; the loss is the mean of the per-group
    means, and gradients are averaged over the ranks."""
    spec = get_gnn(model)

    def train_step(params, opt_state, x_in, hops_flat, labels):
        grp = group or dist.group.WORLD
        G, rows = x_in.shape[0], x_in.shape[1]
        n_layers = len(params)
        with torch.enable_grad():
            h = x_in.reshape(G * rows, -1)
            for i, layer in enumerate(params):
                n_src, n_dst, _ = hop_sizes[i]
                src, dst, mask, deg = hops_flat[i]
                ga = h.reshape(G, rows, -1)[:, :n_src].reshape(G * n_src, -1)
                h = spec.apply_layer(
                    layer, ga, _block_topo(src, dst, mask, deg, n_src, n_dst),
                    activate=(i < n_layers - 1))
                rows = n_dst
            h = h.reshape(G, rows, -1)
            if loss_kind == "mse":
                per = ((h - labels) ** 2).sum(dim=(1, 2)) / (rows * h.shape[2])
            else:
                lp = torch.log_softmax(h, dim=-1)
                per = -lp.gather(2, labels.long()[..., None])[..., 0].sum(
                    dim=1) / rows
            loss = per.mean()
            grads = _grads(loss, params)
        return _update(params, opt_state, loss, grads, grp, True, lr)

    return train_step


def make_batched_graph_train_step(
    model: str, n_nodes: int, loss_kind: str = "ce", lr: float = 1e-3,
    group=None,
):
    """Batched small-graph training (the ``molecule`` shape):
    ``train_step(params, opt_state, x, src, dst, mask, deg, labels)`` with
    ``B`` graphs of ``n_nodes`` a rank (``x`` ``(B, n_nodes, d)``, edges
    ``(B, E)``, ``deg`` ``(B, n_nodes)``, ``labels`` ``(B,)``), run as one
    block-diagonal graph. Each graph's embedding is the mean of its nodes'
    rows; the loss is ``-log_softmax(embedding)[label]`` (or the mean
    squared error), averaged over the graphs, then over the ranks."""
    spec = get_gnn(model)

    def train_step(params, opt_state, x, src, dst, mask, deg, labels):
        grp = group or dist.group.WORLD
        B = x.shape[0]
        topo = _block_topo(src, dst, mask, deg, n_nodes, n_nodes)
        n_layers = len(params)
        with torch.enable_grad():
            h = x.reshape(B * n_nodes, -1)
            for i, layer in enumerate(params):
                h = spec.apply_layer(layer, h, topo,
                                     activate=(i < n_layers - 1))
            g = h.reshape(B, n_nodes, -1).mean(dim=1)
            if loss_kind == "mse":
                loss = ((g - labels) ** 2).mean(dim=1).mean()
            else:
                lp = torch.log_softmax(g, dim=-1)
                loss = -lp.gather(1, labels.long()[:, None])[:, 0].mean()
            grads = _grads(loss, params)
        return _update(params, opt_state, loss, grads, grp, True, lr)

    return train_step


def batched_graph_inputs(
    n_nodes: int, n_edges: int, d_feat: int, d_out: int, batch: int, mesh,
    loss_kind: str = "ce",
):
    """Abstract arguments of the batched-graph step, each ``Shard(0)``
    over the data dims."""
    args = (
        _meta((batch, n_nodes, d_feat)),
        _meta((batch, n_edges), torch.int32),
        _meta((batch, n_edges), torch.int32),
        _meta((batch, n_edges)),
        _meta((batch, n_nodes)),
        _labels((batch,), d_out, loss_kind),
    )
    lead = _rows(mesh)
    return args, tuple(lead for _ in args)


def mfg_inputs(
    hop_sizes: Sequence[tuple], d_feat: int, d_out: int, n_groups: int,
    mesh, loss_kind: str = "ce",
):
    """Abstract arguments of the MFG step, ``((x_in, hops, labels),
    (placements of each))``, the group axis ``Shard(0)`` over the data
    dims."""
    x_in = _meta((n_groups, hop_sizes[0][0], d_feat))
    hops = tuple(
        (_meta((n_groups, n_e), torch.int32),
         _meta((n_groups, n_e), torch.int32),
         _meta((n_groups, n_e)),
         _meta((n_groups, n_dst)))
        for (n_src, n_dst, n_e) in hop_sizes
    )
    labels = _labels((n_groups, hop_sizes[-1][1]), d_out, loss_kind)
    lead = _rows(mesh)
    shard_hops = tuple((lead, lead, lead, lead) for _ in hops)
    return (x_in, hops, labels), (lead, shard_hops, lead)
