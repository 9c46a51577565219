"""A plain GCNII (Chen, Wei, Huang, Ding and Li, "Simple and Deep Graph
Convolutional Networks", ICML 2020, eq. 5) over the whole graph, written
from the paper and the authors' code, for the port's tests to be held
against. It imports neither ``repro_torch`` nor ``repro``.

``H^0 = relu(X W_in^T + b_in)``; for ``l = 1 .. L``:
``S = (1 - alpha) P H^{l-1} + alpha H^0`` and
``H^l = relu((1 - beta_l) S + beta_l S W_l)`` with
``beta_l = ln(lambda / l + 1)``; the logits are ``H^L W_out^T + b_out``.
``P = D^{-1/2} A D^{-1/2}`` over the graph's edges as given (the tests'
graphs carry their self-loops), with in-degrees counted at least 1. No
dropout; the convolutions carry no bias.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ALPHA = 0.1
LAMBDA = 0.4


def beta(l: int, lam: float = LAMBDA) -> float:
    return math.log(lam / l + 1.0)


def adjacency(indptr: np.ndarray, indices: np.ndarray, dtype=torch.float64,
              device="cpu") -> torch.Tensor:
    """``P`` as a sparse ``(n, n)`` matrix: row ``dst``, column ``src``."""
    n = indptr.shape[0] - 1
    dst = torch.from_numpy(np.repeat(np.arange(n), np.diff(indptr))).to(device)
    src = torch.from_numpy(indices.astype(np.int64)).to(device)
    deg = torch.zeros(n, dtype=dtype, device=device)
    deg.index_add_(0, dst, torch.ones_like(dst, dtype=dtype))
    deg = deg.clamp_min(1.0)
    w = 1.0 / torch.sqrt(deg[src] * deg[dst])
    return torch.sparse_coo_tensor(torch.stack([dst, src]), w, (n, n)
                                   ).coalesce()


def n_convs(params: Dict[str, torch.Tensor]) -> int:
    return sum(1 for k in params if k.endswith(".w"))


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
            adj: torch.Tensor, alpha: float = ALPHA,
            lam: float = LAMBDA) -> torch.Tensor:
    """The logits. ``params``: ``"0.lin.weight"``, ``"0.lin.bias"``,
    ``"<l>.w"`` for ``l = 1 .. L`` and ``"<L+1>.lin.weight"``,
    ``"<L+1>.lin.bias"`` (``lin.weight`` is ``(d_out, d_in)``, ``w`` is
    ``(d, d)`` and right-multiplies)."""
    n_conv = n_convs(params)
    h0 = torch.relu(x @ params["0.lin.weight"].T + params["0.lin.bias"])
    h = h0
    for l in range(1, n_conv + 1):
        s = (1.0 - alpha) * torch.sparse.mm(adj, h) + alpha * h0
        b = beta(l, lam)
        h = torch.relu((1.0 - b) * s + b * (s @ params[f"{l}.w"]))
    out = n_conv + 1
    return h @ params[f"{out}.lin.weight"].T + params[f"{out}.lin.bias"]


def loss(params: Dict[str, torch.Tensor], x: torch.Tensor, adj: torch.Tensor,
         labels: torch.Tensor, **kw) -> torch.Tensor:
    """Mean cross-entropy over every node."""
    logp = torch.log_softmax(forward(params, x, adj, **kw), dim=-1)
    return -logp.gather(1, labels.long()[:, None])[:, 0].mean()
