"""GCN (Kipf and Welling, arXiv:1609.02907) over the whole graph:
``h' = act(W (sum_e w_e h[src_e]) + b)`` with the symmetric weight
``w_e = 1 / sqrt(deg(src) deg(dst))``, in-degrees counted with the
self-loops and at least 1, ReLU between layers and none after the last."""
from __future__ import annotations

import numpy as np
import torch


def param_init(config: dict):
    """``[(key, shape, scale)]``: weights N(0, 1) / sqrt(d_in), biases 0."""
    dims = config["dims"]
    out = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        out.append((f"{i}.lin.weight", (d_out, d_in), 1.0 / np.sqrt(d_in)))
        out.append((f"{i}.lin.bias", (d_out,), 0.0))
    return out


def forward(params, x: torch.Tensor, graph, config: dict) -> torch.Tensor:
    deg = graph.in_degree(x.dtype)
    w = torch.rsqrt(deg[graph.src] * deg[graph.dst])
    adj = torch.sparse_coo_tensor(
        torch.stack([graph.dst, graph.src]), w, (graph.n, graph.n),
        check_invariants=False,
    ).coalesce()
    h = x
    for i, layer in enumerate(params):
        h = torch.sparse.mm(adj, h) @ layer["lin.weight"].T + layer["lin.bias"]
        if i < len(params) - 1:
            h = torch.relu(h)
    return h


def forward_flops(config: dict, n_nodes: int, n_edges: int) -> float:
    """A forward's model FLOPs: per layer one multiply-add per edge and
    input channel and the dense product (``gnn_epoch_flops``' terms)."""
    dims = config["dims"]
    return sum(2.0 * n_edges * a + 2.0 * n_nodes * a * b
               for a, b in zip(dims[:-1], dims[1:]))
