"""Family-level ``ArchSpec`` builders (the reference's
``configs/builders.py``): LM (dense or MoE FFNs, GQA or MLA attention),
GNN and recsys.

A build takes the cell's shape name and a ``("data", "model")``
:class:`~torch.distributed.device_mesh.DeviceMesh`
(``repro_torch.launch.mesh.make_host_mesh``) and returns a
:class:`~repro_torch.configs.base.Built`: the step (per-rank for a GNN,
over whole tensors for an LM or recsys cell: ``Built.layout``), its abstract
arguments on the ``meta`` device (parameters and optimizer state
included) and one placement tuple per argument (a dict of them for a
parameter tree whose leaves differ).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import (
    ArchSpec, Built, Cell, GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
    gnn_model_flops, lm_attention_correction, lm_model_flops, mfg_hop_sizes,
    recsys_model_flops,
)
from repro_torch.distributed import gnn_parallel as gp
from repro_torch.launch.mesh import axis_size, data_axes
from repro_torch.models.gnn.layers import get_gnn
from repro_torch.models.lm import steps as lm_steps
from repro_torch.models.lm.sharding import (
    batch_spec, best_spec, placements, replicated,
)
from repro_torch.models.lm.transformer import LMConfig
from repro_torch.models.recsys.two_tower import (
    TwoTower, TwoTowerConfig, score_candidates, serve_user_tower,
    two_tower_value_and_grad,
)
from repro_torch.optim.adamw import adamw_init, adamw_update


# --------------------------------------------------------------------------
# LM
# --------------------------------------------------------------------------

LM_LONG_SKIP = ("full-attention arch: long_500k requires sub-quadratic "
                "attention (DESIGN.md §4)")


def make_lm_arch(cfg: LMConfig, describe: str,
                 smoke_cfg: LMConfig) -> ArchSpec:
    # long_500k needs a sliding window
    cells = {shape: Cell(kind=s["kind"], skip=(
        LM_LONG_SKIP if shape == "long_500k" and not cfg.sub_quadratic
        else None)) for shape, s in LM_SHAPES.items()}

    def build(shape: str, mesh, n_layers: Optional[int] = None,
              unroll: bool = False, variant: Optional[str] = None) -> Built:
        """The cell's step at ``cfg`` (``n_layers`` cuts its depth;
        ``unroll`` sets ``unroll_layers``, which the port's layer loop
        does not need; LM variants are chosen by environment flags, as in
        the reference). The step runs on the mesh's device type."""
        c = cfg
        if n_layers is not None or unroll:
            c = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                                    unroll_layers=unroll)
        s = LM_SHAPES[shape]
        kind, batch, seq = s["kind"], s["batch"], s["seq"]
        device = mesh.device_type
        out_sh = None
        if kind == "train":
            fn = lm_steps.make_train_step(c, mesh, device=device)[0]
            args, shard = lm_steps.lm_train_inputs(c, batch, seq, mesh)
            # parameters and optimizer state keep their placements
            out_sh = (shard[0], shard[1], None)
        elif kind == "prefill":
            fn = lm_steps.make_prefill_step(c, device=device)
            args, shard = lm_steps.lm_prefill_inputs(c, batch, seq, mesh)
        else:
            fn = lm_steps.make_decode_step(c, device=device)
            args, shard = lm_steps.lm_decode_inputs(c, batch, seq, mesh)
            out_sh = (None, shard[1])       # the cache keeps its placements
        corr = lm_attention_correction(c, kind, batch, seq)
        meta = dict(
            model_flops=lm_model_flops(c, kind, batch, seq) + corr["flops"],
            attn_corr_flops=corr["flops"],
            attn_corr_bytes=corr["bytes"],
            params=c.param_count(),
            active_params=c.active_param_count(),
            kind=kind,
        )
        return Built(fn, args, shard, meta, out_shardings=out_sh,
                     layout="global")

    def smoke(device=None) -> dict:
        """``lm_loss`` and its gradients at ``smoke_cfg`` on ``device``
        (the CUDA card unless ``device="cpu"``): weights from
        ``torch.Generator`` seed 0, tokens ``(2, 32)`` uniform from numpy
        seed 1. Returns ``loss``, ``grad_norm`` (the sum of every
        gradient's absolute values) and ``finite`` (loss and
        ``grad_norm``)."""
        from repro_torch.device import resolve_device
        from repro_torch.models.lm.transformer import (
            init_lm_params, lm_value_and_grad,
        )

        device = resolve_device(device)
        model = init_lm_params(smoke_cfg,
                               torch.Generator(device).manual_seed(0), device)
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, smoke_cfg.vocab, (2, 32)).astype(np.int32)).to(device)
        (loss, _), grads = lm_value_and_grad(model, toks)
        gn = float(sum(float(g.abs().sum()) for g in grads.values()))
        return dict(loss=float(loss), grad_norm=gn,
                    finite=bool(np.isfinite(float(loss)) and np.isfinite(gn)))

    # the dry run's calibration depths, past an MoE config's dense layers
    fd = cfg.n_dense
    return ArchSpec(cfg.name, "lm", describe, cells, build, smoke,
                    layer_calib=(fd + 2, fd + 4, cfg.n_layers), config=cfg,
                    smoke_config=smoke_cfg)


# --------------------------------------------------------------------------
# GNN
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GNNArch:
    name: str
    model: str             # key in GNN_REGISTRY
    n_layers: int
    d_hidden: int
    loss_kind: str = "ce"  # graphcast: "mse"
    d_out_override: Optional[int] = None   # graphcast: 227 vars
    note: str = ""


def _gnn_dims(a: GNNArch, d_feat: int, classes: int):
    d_out = a.d_out_override or classes
    return [d_feat] + [a.d_hidden] * (a.n_layers - 1) + [d_out]


def _abstract_gnn_params(a: GNNArch, dims):
    return get_gnn(a.model).init(torch.Generator(), dims[0], a.d_hidden,
                                 dims[-1], a.n_layers, device="meta")


def make_gnn_arch(a: GNNArch, describe: str) -> ArchSpec:
    cells = {s: Cell(kind=v["kind"]) for s, v in GNN_SHAPES.items()}

    def build(shape: str, mesh, variant: str = "base") -> Built:
        """variant: "base" (CAGNET-style, sharded, per-layer remat) |
        "unsharded" (every rank computes the whole graph, no remat) |
        "halo" (partitioned-halo; full-graph shapes only)."""
        s = GNN_SHAPES[shape]
        dims = _gnn_dims(a, s["d_feat"], s.get("classes", 16))
        d_out = dims[-1]
        p_abs = _abstract_gnn_params(a, dims)
        o_abs = adamw_init(p_abs)
        rep = replicated(mesh)
        oshard = {"m": rep, "v": rep, "step": rep}
        group = mesh.get_group("data")

        if s["kind"] == "fullgraph" and variant == "halo":
            n_local, n_halo, args, shard = gp.partitioned_inputs(
                s["n_nodes"], s["n_edges"], s["d_feat"], d_out, mesh,
                loss_kind=a.loss_kind,
            )
            fn = gp.make_partitioned_train_step(
                a.model, n_local, n_halo, mesh, loss_kind=a.loss_kind,
            )
            flops = gnn_model_flops(dims, s["n_nodes"], s["n_edges"],
                                    model=a.model)
            meta = dict(model_flops=flops, kind="train", dims=dims,
                        variant=variant)
            return Built(fn, (p_abs, o_abs) + tuple(args),
                         (rep, oshard) + tuple(shard), meta)
        if s["kind"] == "fullgraph":
            n_pad, args, shard = gp.fullgraph_inputs(
                s["n_nodes"], s["n_edges"], s["d_feat"], d_out, mesh,
                loss_kind=a.loss_kind,
            )
            fn = gp.make_fullgraph_train_step(
                a.model, n_pad, loss_kind=a.loss_kind,
                sharded=(variant != "unsharded"),
                remat=(variant != "unsharded"), group=group,
            )
            flops = gnn_model_flops(dims, s["n_nodes"], s["n_edges"],
                                    model=a.model)
        elif s["kind"] == "mfg":
            n_groups = axis_size(mesh, data_axes(mesh))
            hops = mfg_hop_sizes(
                a.n_layers, s["batch_nodes"], s["fanout"], s["n_nodes"],
                n_groups,
            )
            fn = gp.make_mfg_train_step(a.model, hops,
                                        loss_kind=a.loss_kind, group=group)
            args, shard = gp.mfg_inputs(
                hops, s["d_feat"], d_out, n_groups, mesh,
                loss_kind=a.loss_kind,
            )
            tot_e = n_groups * sum(h[2] for h in hops)
            tot_n = n_groups * sum(h[1] for h in hops)
            flops = gnn_model_flops(
                dims, tot_n // max(a.n_layers, 1),
                tot_e // max(a.n_layers, 1), model=a.model,
            )
        else:  # batched small graphs
            fn = gp.make_batched_graph_train_step(
                a.model, s["n_nodes"], loss_kind=a.loss_kind, group=group,
            )
            args, shard = gp.batched_graph_inputs(
                s["n_nodes"], s["n_edges"], s["d_feat"], d_out, s["batch"],
                mesh, loss_kind=a.loss_kind,
            )
            flops = s["batch"] * gnn_model_flops(
                dims, s["n_nodes"], s["n_edges"], model=a.model
            )
        meta = dict(model_flops=flops, kind="train", dims=dims)
        return Built(fn, (p_abs, o_abs) + tuple(args),
                     (rep, oshard) + tuple(shard), meta)

    def smoke(device=None):
        """One forward, loss and gradient at reduced widths (at most 3
        layers of 32; 24 input features, 8 classes or 12 regression
        outputs) on ``kronecker_graph(512, 6)`` plus self loops, weights
        from ``torch.Generator`` seed 0, on ``device`` (the CUDA card
        unless ``device="cpu"``)."""
        from repro_torch.device import resolve_device
        from repro_torch.graph import gcn_norm_coeffs, kronecker_graph
        from repro_torch.graph.csr import add_self_loops
        from repro_torch.graph.synthetic import random_features, random_labels
        from repro_torch.models.gnn.layers import (
            full_graph_forward, full_graph_topo, softmax_xent,
        )

        device = resolve_device(device)
        spec = get_gnn(a.model)
        g = add_self_loops(kronecker_graph(512, 6, seed=0))
        d_feat = 24
        n_layers = min(a.n_layers, 3)
        d_hidden = min(a.d_hidden, 32)
        d_out = 8 if a.loss_kind == "ce" else 12
        params = spec.init(torch.Generator().manual_seed(0), d_feat,
                           d_hidden, d_out, n_layers, device=device)
        x = random_features(g.n_nodes, d_feat, 0)
        topo = full_graph_topo(g.indptr, g.indices, g.n_nodes,
                               gcn_norm_coeffs(g), device=device)
        with torch.enable_grad():
            out = full_graph_forward(spec, params, x, topo)
            if a.loss_kind == "mse":
                y = torch.from_numpy(
                    random_features(g.n_nodes, d_out, 1)).to(device)
                loss = ((out - y) ** 2).mean()
            else:
                y = torch.from_numpy(
                    random_labels(g.n_nodes, d_out, 1)).to(device)
                loss = softmax_xent(out, y)
            grads = torch.autograd.grad(loss, list(params.parameters()))
        loss, out = loss.detach(), out.detach()
        gn = float(sum(float(t.abs().sum()) for t in grads))
        return dict(
            loss=float(loss), grad_norm=gn, out_shape=tuple(out.shape),
            finite=bool(torch.isfinite(out).all())
            and bool(np.isfinite(float(loss))),
        )

    return ArchSpec(a.name, "gnn", describe, cells, build, smoke, config=a)


# --------------------------------------------------------------------------
# RecSys
# --------------------------------------------------------------------------

def _abstract_two_tower(cfg: TwoTowerConfig) -> TwoTower:
    def m(*shape):
        return torch.empty(shape, dtype=cfg.dtype, device="meta")

    def tower(n_fields):
        dims = [n_fields * cfg.embed_dim] + list(cfg.tower_mlp)
        return [(m(dims[i], dims[i + 1]), m(dims[i + 1]))
                for i in range(len(cfg.tower_mlp))]

    return TwoTower(m(cfg.user_vocab, cfg.embed_dim),
                    m(cfg.item_vocab, cfg.embed_dim),
                    tower(cfg.n_user_fields), tower(cfg.n_item_fields))


SMOKE_BATCH = 8


def make_recsys_arch(cfg: TwoTowerConfig, describe: str,
                     smoke_cfg: TwoTowerConfig) -> ArchSpec:
    cells = {s: Cell(kind=v["kind"]) for s, v in RECSYS_SHAPES.items()}

    def build(shape: str, mesh) -> Built:
        s = RECSYS_SHAPES[shape]
        batch = s["batch"]
        p_abs = _abstract_two_tower(cfg)
        pshard = {k: (replicated(mesh) if v.dim() <= 1
                      else placements(mesh, best_spec(v.shape, mesh)))
                  for k, v in p_abs.state_dict(keep_vars=True).items()}
        bsh = placements(mesh, batch_spec(batch, mesh))

        def ids(n_fields):
            return torch.empty((batch, n_fields, cfg.bag_size),
                               dtype=torch.int32, device="meta")

        uids = ids(cfg.n_user_fields)
        if s["kind"] == "train":
            o_abs = adamw_init(p_abs)
            oshard = {"m": pshard, "v": pshard, "step": replicated(mesh)}

            def fn(params, opt_state, u, i):
                (loss, _), grads = two_tower_value_and_grad(params, u, i, cfg)
                params2, opt2 = adamw_update(grads, params, opt_state, lr=1e-3)
                return params2, opt2, loss

            args = (p_abs, o_abs, uids, ids(cfg.n_item_fields))
            shard = (pshard, oshard, bsh, bsh)
            flops = recsys_model_flops(cfg, "train", batch)
        elif s["kind"] == "serve":
            def fn(params, u):
                return serve_user_tower(params, u, cfg)

            args = (p_abs, uids)
            shard = (pshard, bsh)
            flops = recsys_model_flops(cfg, "serve", batch)
        else:  # retrieval
            nc = s["n_candidates"]
            cand = torch.empty((nc, cfg.tower_mlp[-1]), dtype=torch.float32,
                               device="meta")

            def fn(params, u, c):
                return score_candidates(params, u, c, cfg, top_k=128)

            args = (p_abs, uids, cand)
            shard = (pshard, replicated(mesh),
                     placements(mesh, (data_axes(mesh), None)))
            flops = recsys_model_flops(cfg, "retrieval", batch, nc)
        meta = dict(model_flops=flops, kind=s["kind"])
        return Built(fn, args, shard, meta, layout="global")

    def smoke(device=None) -> dict:
        """One in-batch softmax loss and its gradients at ``smoke_cfg``
        widths on ``device`` (the CUDA card unless ``device="cpu"``):
        weights from ``torch.Generator`` seed 0, 8 users and items of
        random ids (numpy seeds 1 and 2), through the kernel path
        (``kernels="auto"``) and the reference path.

        Returns ``loss``, ``acc``, ``grad_norm`` (the sum of every
        gradient's absolute values), ``finite`` (loss and every gradient),
        ``kernel_matches_reference`` (loss and every gradient bitwise) and
        ``launches`` (each kernel's launches in the kernel path's call: two
        ``embedding_bag`` and two ``scatter_add`` on the card, none on the
        CPU, checked in ``launches_ok``)."""
        from repro_torch.device import resolve_device
        from repro_torch.kernels import launch_counts, reset_launches
        from repro_torch.models.recsys.two_tower import init_two_tower

        c = smoke_cfg
        device = resolve_device(device)
        model = init_two_tower(c, torch.Generator(device).manual_seed(0),
                               device)

        def ids(seed, n_fields, vocab):
            a = np.random.default_rng(seed).integers(
                0, vocab, (SMOKE_BATCH, n_fields, c.bag_size))
            return torch.from_numpy(a.astype(np.int32)).to(device)

        u = ids(1, c.n_user_fields, c.user_vocab)
        i = ids(2, c.n_item_fields, c.item_vocab)
        reset_launches()
        (loss, acc), grads = two_tower_value_and_grad(model, u, i, c, "auto")
        launches = {k: v for k, v in launch_counts().items() if v}
        (loss_r, _), grads_r = two_tower_value_and_grad(model, u, i, c,
                                                        "reference")
        want = ({"embedding_bag": 2, "scatter_add": 2}
                if device.type == "cuda" else {})
        return dict(
            loss=float(loss), acc=float(acc),
            grad_norm=float(sum(float(g.abs().sum()) for g in grads.values())),
            finite=bool(torch.isfinite(loss)) and all(
                bool(torch.isfinite(g).all()) for g in grads.values()),
            kernel_matches_reference=bool(torch.equal(loss, loss_r)) and all(
                torch.equal(grads[k], grads_r[k]) for k in grads),
            launches=launches, launches_ok=launches == want,
        )

    return ArchSpec(cfg.name, "recsys", describe, cells, build, smoke,
                    config=cfg)
