"""Micro-batch full-graph training baseline (Betty, ASPLOS'23 — paper §2/App.B).

The port of the reference's ``core/microbatch.py``: gradients accumulated
over message-flow graphs (MFGs) that retain ALL neighbour information across
all layers (no sampling), then one weight update. It exhibits the
neighbour-explosion failure mode: the innermost hop's node set approaches
|V| even for modest L, which is what the paper's Table 1 shows as GPU OOM /
slowdowns. Peak MFG size is surfaced so benchmarks can report the
explosion factor.

The MFGs are bitwise the reference's; the hop function is vectorised (no
Python loop over destination vertices). The layers are the families' plain
``apply_layer`` functions under torch autograd, as the reference runs its
plain JAX layers: no kernel is on this path.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.csr import CSRGraph
from repro_torch.models.gnn.layers import GNNSpec, LocalTopo, softmax_xent


def _full_hop(
    g: CSRGraph, dst_ids: np.ndarray, edge_weight: Optional[np.ndarray]
):
    """All in-edges of dst_ids: (node_ids, src_local, dst_local, ew, deg).

    Edges come in ``dst_ids`` order, each vertex's CSR run in place;
    ``node_ids`` is ``dst_ids`` followed by the other sources in ascending
    order (the reference's ``setdiff1d`` of the union)."""
    starts = g.indptr[dst_ids].astype(np.int64)
    deg = (g.indptr[dst_ids + 1] - g.indptr[dst_ids]).astype(np.int64)
    # edge positions: the arange of all edges, shifted run by run onto each
    # vertex's CSR run
    first = np.cumsum(deg) - deg
    epos = np.repeat(starts - first, deg) + np.arange(int(deg.sum()),
                                                      dtype=np.int64)
    srcs = g.indices[epos].astype(np.int64)
    dst_local = np.repeat(np.arange(len(dst_ids), dtype=np.int64), deg)
    # dst first ordering
    is_extra = np.zeros(g.n_nodes, bool)
    is_extra[srcs] = True
    is_extra[dst_ids] = False
    extra = np.flatnonzero(is_extra).astype(np.int64)
    node_ids = np.concatenate([dst_ids, extra])
    lut = np.full(g.n_nodes, -1, np.int64)
    lut[node_ids] = np.arange(len(node_ids))
    src_local = lut[srcs]
    ew = (
        edge_weight[epos].astype(np.float32)
        if edge_weight is not None
        else np.ones(len(epos), np.float32)
    )
    return node_ids, src_local, dst_local, ew, deg


def build_full_mfg(
    g: CSRGraph,
    seeds: np.ndarray,
    n_layers: int,
    edge_weight: Optional[np.ndarray] = None,
) -> Tuple[List[dict], np.ndarray]:
    """L hops of full-neighborhood expansion, innermost first."""
    hops = []
    dst = np.asarray(seeds, dtype=np.int64)
    for _ in range(n_layers):
        node_ids, src_local, dst_local, ew, deg = _full_hop(g, dst, edge_weight)
        hops.append(
            dict(
                node_ids=node_ids,
                n_dst=len(dst),
                src=src_local,
                dst=dst_local,
                ew=ew,
                deg=np.maximum(deg, 1).astype(np.float32),
            )
        )
        dst = node_ids
    hops.reverse()
    return hops, np.asarray(seeds, dtype=np.int64)


def _hop_topo(h: dict, device: torch.device) -> LocalTopo:
    e = len(h["src"])
    n_dst = h["n_dst"]

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return LocalTopo(
        src=t(h["src"], np.int32),
        dst=t(h["dst"], np.int32),
        n_dst=n_dst,
        edge_weight=t(h["ew"], np.float32),
        edge_mask=torch.ones((e,), dtype=torch.float32, device=device),
        in_deg=t(h["deg"], np.float32),
        dst_self=torch.arange(n_dst, dtype=torch.int32, device=device),
        n_real_edges=e,
    )


def mfg_forward(spec: GNNSpec, params: List, x_in: torch.Tensor,
                hops: List[dict]) -> torch.Tensor:
    """The layers over the hops, innermost first, on ``x_in``'s device."""
    h = x_in
    for i, hop in enumerate(hops):
        topo = _hop_topo(hop, x_in.device)
        h = spec.apply_layer(
            params[i], h, topo, activate=(i < len(hops) - 1)
        )
    return h


def microbatch_grads(
    spec: GNNSpec,
    params: List,
    g: CSRGraph,
    x: np.ndarray,
    labels: np.ndarray,
    n_micro: int,
    edge_weight: Optional[np.ndarray] = None,
    device: DeviceLike = None,
):
    """Betty-style epoch on ``device`` (the CUDA card unless
    ``device="cpu"``; ``params`` live there): grads accumulated over
    micro-batches of consecutive seed vertices.

    Returns ``(loss, grads, stats)``: ``loss`` a Python float, ``grads`` one
    ``{param_name: tensor}`` dict per layer (``SSOEngine.run_epoch``'s
    layout), and ``stats`` with ``peak_input_nodes`` (the neighbour
    explosion) and ``peak_mfg_edges`` as in the reference, plus per
    micro-batch ``input_nodes`` and ``hop_edges`` (innermost hop first),
    ``host_s`` (the MFG builds and the input features' row gathers on the
    host) and ``device_s`` (the features' copy, forward and backward,
    ending in a synchronise on a card)."""
    device = resolve_device(device)
    n = g.n_nodes
    n_layers = len(params)
    seed_chunks = np.array_split(np.arange(n, dtype=np.int64), n_micro)
    names = [[k for k, _ in layer.named_parameters()] for layer in params]
    leaves = [p for layer in params for p in layer.parameters()]
    grads = None
    total_loss = 0.0
    stats: Dict = dict(peak_input_nodes=0, peak_mfg_edges=0, input_nodes=[],
                       hop_edges=[], host_s=0.0, device_s=0.0)
    for seeds in seed_chunks:
        t0 = time.perf_counter()
        hops, _ = build_full_mfg(g, seeds, n_layers, edge_weight)
        x_np = np.ascontiguousarray(x[hops[0]["node_ids"]])
        t1 = time.perf_counter()
        stats["host_s"] += t1 - t0
        edges = [len(h["src"]) for h in hops]
        stats["input_nodes"].append(len(hops[0]["node_ids"]))
        stats["hop_edges"].append(edges)
        stats["peak_input_nodes"] = max(stats["peak_input_nodes"],
                                        len(hops[0]["node_ids"]))
        stats["peak_mfg_edges"] = max(stats["peak_mfg_edges"], sum(edges))
        x_in = torch.from_numpy(x_np).to(device)
        lab = torch.from_numpy(labels[seeds].astype(np.int32)).to(device)
        with torch.enable_grad():
            logits = mfg_forward(spec, params, x_in, hops)
            loss = softmax_xent(logits, lab, n_total=n)
            gr = torch.autograd.grad(loss, leaves)
        del logits, x_in, x_np
        total_loss += float(loss.detach())
        if grads is None:
            grads = list(gr)
        else:
            for a, b in zip(grads, gr):
                a.add_(b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stats["device_s"] += time.perf_counter() - t1
    it = iter(grads)
    out = [{k: next(it) for k in layer_names} for layer_names in names]
    return total_loss, out, stats
