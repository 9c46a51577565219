"""GAT (Velickovic et al., arXiv:1710.10903) over the whole graph, in the
port's layout: per layer ``h = x W`` split into ``H`` heads (``config
["heads"]``, or one head where the width does not divide), scores
``leaky_relu(a_src . h[src] + a_dst . h[dst], 0.2)`` softmaxed over each
destination's in-edges, ``sum_e attn_e h[src_e] + b``, ELU between layers
and none after the last."""
from __future__ import annotations

import numpy as np
import torch


def heads(config: dict, d_out: int) -> int:
    h = config["heads"]
    return h if d_out % h == 0 else 1


def param_init(config: dict):
    """``[(key, shape, scale)]``: ``w`` N(0, 1) / sqrt(d_in), ``a_src`` and
    ``a_dst`` N(0, 1) * 0.1, ``b`` 0."""
    dims = config["dims"]
    out = []
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        nh = heads(config, d_out)
        out.append((f"{i}.w", (d_in, nh, d_out // nh), 1.0 / np.sqrt(d_in)))
        out.append((f"{i}.a_src", (nh, d_out // nh), 0.1))
        out.append((f"{i}.a_dst", (nh, d_out // nh), 0.1))
        out.append((f"{i}.b", (d_out,), 0.0))
    return out


def forward(params, x: torch.Tensor, graph, config: dict) -> torch.Tensor:
    src, dst, n = graph.src, graph.dst, graph.n
    h_in = x
    for i, layer in enumerate(params):
        d_in, nh, dh = layer["w"].shape
        h = (h_in @ layer["w"].reshape(d_in, nh * dh)).reshape(n, nh, dh)
        e_src = (h * layer["a_src"]).sum(-1)
        e_dst = (h * layer["a_dst"]).sum(-1)
        score = torch.nn.functional.leaky_relu(e_src[src] + e_dst[dst], 0.2)
        smax = torch.full((n, nh), -torch.inf, dtype=score.dtype,
                          device=score.device)
        smax = smax.scatter_reduce(0, dst[:, None].expand(-1, nh),
                                   score.detach(), "amax")
        ex = torch.exp(score - smax[dst])
        den = torch.zeros((n, nh), dtype=ex.dtype, device=ex.device)
        den = den.index_add(0, dst, ex)
        attn = ex / den[dst]
        agg = torch.zeros((n, nh, dh), dtype=h.dtype, device=h.device)
        agg = agg.index_add(0, dst, h[src] * attn[:, :, None])
        h_in = agg.reshape(n, nh * dh) + layer["b"]
        if i < len(params) - 1:
            h_in = torch.nn.functional.elu(h_in)
    return h_in


def forward_flops(config: dict, n_nodes: int, n_edges: int) -> float:
    """A forward's model FLOPs per layer: the dense product, the two score
    projections, seven per edge and head (add, leaky ReLU, max, subtract,
    exp, sum, divide), a weighted sum per edge and channel, the bias."""
    dims = config["dims"]
    total = 0.0
    for a, b in zip(dims[:-1], dims[1:]):
        nh = heads(config, b)
        total += (2.0 * n_nodes * a * b + 4.0 * n_nodes * b
                  + 7.0 * n_edges * nh + 2.0 * n_edges * b + n_nodes * b)
    return total
