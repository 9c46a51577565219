"""Config registry substrate (the reference's ``configs/base.py``): arch
specs, cells (arch x shape), the built step of a cell, the workload shapes
and the model FLOP counts.

Every registered architecture has an :class:`ArchSpec` whose ``build(shape,
mesh)`` returns a :class:`Built`: the step function of that cell, its
abstract arguments (``meta``-device tensors: shapes and dtypes, no memory),
one ``torch.distributed.tensor`` placement tuple per argument (over the
mesh's ``("data", "model")`` dims) and ``meta`` (``model_flops``, the
analytic model FLOPs of one call, ``kind`` and, for GNNs, ``dims``). Where
the reference sets them, ``out_shardings`` gives the outputs that keep an
input's placements through the step (an LM train step's parameters and
optimizer state, a decode step's cache), None for the others.

``layout`` says how the step is written. A ``"per_rank"`` step (the GNN
steps, ``repro_torch.distributed.gnn_parallel``) takes each argument's
local shard on its rank, the part of the global shape that its placements
give the rank, and calls its collectives itself. A ``"global"`` step (the
LM and recsys steps) is written over whole tensors, as the reference's are
for GSPMD to partition: on one card it takes plain tensors, and spread over
a mesh it takes ``DTensor``s of the placements, DTensor's propagation and
the ``constrain`` pins (``models/lm/sharding.py``) standing in for GSPMD's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Built:
    fn: Callable
    args: Tuple
    in_shardings: Tuple
    meta: Dict[str, Any]
    out_shardings: Any = None      # outputs that keep an input's placements
    layout: str = "per_rank"       # per_rank | global: how fn takes its args


@dataclasses.dataclass
class Cell:
    kind: str                      # train | prefill | decode | serve | retrieval
    skip: Optional[str] = None     # reason if this cell is skipped


@dataclasses.dataclass
class ArchSpec:
    """An architecture of the registry. ``smoke(device=None)`` runs its
    reduced configuration once (the CUDA card unless ``device="cpu"``) and
    returns ``loss``, ``grad_norm`` and ``finite``; ``config`` is the
    family's configuration (an ``LMConfig``, a ``GNNArch``, whose
    ``model`` names the GNN family, or a ``TwoTowerConfig``) and
    ``smoke_config`` the reduced one an LM's ``smoke`` runs at.
    ``layer_calib`` is the reference's (L1, L2, L_full) depth calibration
    of scanned-layer archs, None for the others."""

    name: str
    family: str                    # lm | gnn | recsys
    describe: str
    cells: Dict[str, Cell]
    build: Callable[..., Built]
    smoke: Callable[..., Dict[str, Any]]
    layer_calib: Optional[Tuple[int, int, int]] = None
    config: Any = None
    smoke_config: Any = None

    def runnable_shapes(self) -> List[str]:
        return [s for s, c in self.cells.items() if c.skip is None]


# the assigned GNN shape set (shared by the GNN archs)
GNN_SHAPES: Dict[str, Dict[str, Any]] = {
    "full_graph_sm": dict(
        kind="fullgraph", n_nodes=2708, n_edges=10556, d_feat=1433, classes=7,
    ),
    "minibatch_lg": dict(
        kind="mfg", n_nodes=232965, n_edges=114615892, batch_nodes=1024,
        fanout=(15, 10), d_feat=602, classes=41,
    ),
    "ogb_products": dict(
        kind="fullgraph", n_nodes=2449029, n_edges=61859140, d_feat=100,
        classes=47,
    ),
    "molecule": dict(
        kind="batched", n_nodes=30, n_edges=64, batch=128, d_feat=32,
        classes=16,
    ),
}

LM_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

RECSYS_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}


def mfg_hop_sizes(
    n_layers: int, batch_nodes: int, fanout, n_nodes: int, n_groups: int,
) -> List[Tuple[int, int, int]]:
    """Static padded hop sizes of the sampled-training cell, innermost
    first ``[(n_src, n_dst, n_edges)]``, each rounded up to a multiple of 8.

    GraphSAINT-style: the innermost ``n_layers - len(fanout)`` layers run on
    the sampled subgraph itself; the last ``len(fanout)`` layers contract
    through the MFG hops (``batch_nodes / n_groups`` seeds a group)."""
    seeds = max(batch_nodes // n_groups, 1)
    sizes = [seeds]
    edges = []
    for f in fanout:  # outermost (seed side) first
        e = sizes[-1] * f
        s = min(sizes[-1] + e, n_nodes)
        edges.append(e)
        sizes.append(s)

    def r8(x):
        return int(((x + 7) // 8) * 8)

    hops = []
    inner = r8(sizes[-1])
    sub_edges = r8(edges[-1])
    for _ in range(max(n_layers - len(fanout), 0)):
        hops.append((inner, inner, sub_edges))
    for i in reversed(range(len(fanout))):
        hops.append((r8(sizes[i + 1]), r8(sizes[i]), r8(edges[i])))
    return hops


def gnn_model_flops(
    dims, n_nodes: int, n_edges: int, train: bool = True,
    model: str = "gcn",
) -> float:
    """Model FLOPs of one GNN call over ``n_nodes`` / ``n_edges`` at widths
    ``dims``, times 3 in training. Edge-MLP models (graphcast) do O(d^2)
    work per edge, which dominates at ogb scale."""
    f = 0.0
    for i in range(len(dims) - 1):
        d_in, d_out = dims[i], dims[i + 1]
        if model == "graphcast":
            # edge MLP (2d->h->h) + node MLP ((d+h)->h->h) + residual proj
            h = d_out
            f += 2.0 * n_edges * (2 * d_in * h + h * h)
            f += 2.0 * n_nodes * ((d_in + h) * h + h * h + d_in * h)
        elif model == "pna":
            # pre-MLP per node, 4 aggregators x 3 scalers, post-MLP
            f += 2.0 * n_nodes * d_in * d_in
            f += 8.0 * n_edges * d_in
            f += 2.0 * n_nodes * (12 * d_in + d_in) * d_out
        elif model == "sage":
            f += 2.0 * n_edges * d_in
            f += 4.0 * n_nodes * d_in * d_out        # self + neighbor
        elif model == "gat":
            f += 8.0 * n_edges * d_out               # scores + weighted agg
            f += 2.0 * n_nodes * d_in * d_out
        else:  # gcn/gin
            f += 2.0 * n_edges * d_in                # aggregation
            f += 2.0 * n_nodes * d_in * d_out        # vertex matmul
    return (3.0 if train else 1.0) * f


def recsys_model_flops(cfg, kind: str, batch: int, n_candidates: int = 0) -> float:
    """Matrix-product FLOPs of one two-tower call: the towers' MLPs (times 3
    in training: forward and two backward products) and, in training, the
    in-batch logits; in retrieval the candidate scores. The bag sums are
    not counted (they are memory-bound)."""
    dims_u = [cfg.n_user_fields * cfg.embed_dim] + list(cfg.tower_mlp)
    dims_i = [cfg.n_item_fields * cfg.embed_dim] + list(cfg.tower_mlp)
    mlp_u = sum(2 * a * b for a, b in zip(dims_u[:-1], dims_u[1:]))
    mlp_i = sum(2 * a * b for a, b in zip(dims_i[:-1], dims_i[1:]))
    if kind == "train":
        return 3.0 * batch * (mlp_u + mlp_i) + 3.0 * 2 * batch * batch * cfg.tower_mlp[-1]
    if kind == "serve":
        return batch * mlp_u
    return batch * mlp_u + 2.0 * batch * n_candidates * cfg.tower_mlp[-1]


def lm_model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """Model FLOPs of one LM call: 6 (train) or 2 (prefill) per active
    parameter and token; a decode step is 2 per active parameter and
    sequence plus the attention over the ``seq``-long cache (``2 * 2 *
    layers * batch * seq * heads * d_head``, times ``window / seq`` for a
    sliding window). Prefill's attention is not in it: see
    :func:`lm_attention_correction`."""
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * batch * seq
    if kind == "prefill":
        return 2.0 * n_active * batch * seq
    attn = (
        2.0 * 2.0 * cfg.n_layers * batch * seq
        * cfg.n_heads * cfg.d_head
    )
    if cfg.window is not None:
        attn *= min(cfg.window / seq, 1.0)
    return 2.0 * n_active * batch + attn


def lm_attention_correction(cfg, kind: str, batch: int, seq: int):
    """Closed-form attention FLOPs and bytes of a train or prefill call
    (causal, or a sliding window): ``pairs`` (q, k) pairs per head, each
    ``2 * d_qk + 2 * d_v`` FLOPs, times 4 in training (forward, recomputed
    forward, two backward products); bytes with K/V streamed once per
    ``q_chunk`` block and q/out read and written once. Decode: zero."""
    if kind == "decode":
        return dict(flops=0.0, bytes=0.0)
    S, B = seq, batch
    W = cfg.window
    if W is not None and S > W:
        pairs = W * S - W * W / 2.0
    else:
        pairs = S * (S + 1) / 2.0
    if cfg.attn_type == "mla":
        d_qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        d_v = cfg.v_head_dim
        h_kv = cfg.n_heads
    else:
        d_qk = d_v = cfg.d_head
        h_kv = cfg.n_kv_heads
    fwd_flops = B * cfg.n_heads * pairs * (2.0 * d_qk + 2.0 * d_v)
    mult = 4.0 if kind == "train" else 1.0
    flops = mult * cfg.n_layers * fwd_flops
    nq = max(S // cfg.q_chunk, 1)
    kv_bytes = nq * B * h_kv * S * (d_qk + d_v) * 2.0
    qo_bytes = 3.0 * B * cfg.n_heads * S * (d_qk + d_v) * 2.0
    bmult = 3.0 if kind == "train" else 1.0
    nbytes = bmult * cfg.n_layers * (kv_bytes + qo_bytes)
    return dict(flops=flops, bytes=nbytes)
