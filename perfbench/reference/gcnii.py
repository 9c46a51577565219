"""GCNII (Chen, Wei, Huang, Ding and Li, ICML 2020, arXiv:2007.02133,
eq. 5) over the whole graph: ``H^0 = relu(X W_in^T + b_in)``; for each
convolution ``l = 1 .. L``, ``S = (1 - alpha) P H^{l-1} + alpha H^0`` and
``H^l = relu((1 - beta_l) S + beta_l S W_l)`` with ``beta_l = ln(lambda /
l + 1)``; the logits ``H^L W_out^T + b_out``. ``P`` is GCN's symmetric
normalisation over the graph's edges (self-loops included), in-degrees at
least 1. The convolutions carry no bias; ``config["alpha"]`` and
``config["lambda"]`` give the mix."""
from __future__ import annotations

import math

import numpy as np
import torch


def param_init(config: dict):
    """``[(key, shape, scale)]``: the dense layers' weights N(0, 1) /
    sqrt(d_in) and zero biases, each convolution's ``w`` ``(d, d)`` N(0, 1)
    / sqrt(d)."""
    dims = config["dims"]
    last = len(dims) - 2
    out = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        if i in (0, last):
            out.append((f"{i}.lin.weight", (d_out, d_in),
                        1.0 / np.sqrt(d_in)))
            out.append((f"{i}.lin.bias", (d_out,), 0.0))
        else:
            out.append((f"{i}.w", (d_in, d_out), 1.0 / np.sqrt(d_in)))
    return out


def forward(params, x: torch.Tensor, graph, config: dict) -> torch.Tensor:
    alpha, lam = config["alpha"], config["lambda"]
    deg = graph.in_degree(x.dtype)
    w = torch.rsqrt(deg[graph.src] * deg[graph.dst])
    adj = torch.sparse_coo_tensor(
        torch.stack([graph.dst, graph.src]), w, (graph.n, graph.n),
        check_invariants=False,
    ).coalesce()
    first, last = params[0], params[-1]
    h0 = torch.relu(x @ first["lin.weight"].T + first["lin.bias"])
    h = h0
    for l, layer in enumerate(params[1:-1], start=1):
        s = (1.0 - alpha) * torch.sparse.mm(adj, h) + alpha * h0
        beta = math.log(lam / l + 1.0)
        h = torch.relu((1.0 - beta) * s + beta * (s @ layer["w"]))
    return h @ last["lin.weight"].T + last["lin.bias"]


def forward_flops(config: dict, n_nodes: int, n_edges: int) -> float:
    """A forward's model FLOPs: each layer's dense product, ``2 N d_in
    d_out``, and each convolution's aggregation, one multiply-add per edge
    and input channel, ``2 E d_in``."""
    dims = config["dims"]
    last = len(dims) - 2
    total = 0.0
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        total += 2.0 * n_nodes * a * b
        if i not in (0, last):
            total += 2.0 * n_edges * a
    return total
