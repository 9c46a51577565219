"""The plain reference: whole-graph GNN math in plain PyTorch.

It imports nothing of the program and takes nothing the program made: the
benchmark hands it the inputs it made itself (the graph in the generator's
node order, the features, the labels and the weights), and it works out
the rest again: degrees, GCN edge weights, the layers, the loss, the
gradients by autograd and AdamW. One module per model family
(``reference/<model>.py``), each with ``param_init(config)``,
``forward(params, x, graph, config)`` and ``forward_flops(config,
n_nodes, n_edges)``.

It runs in float64 as the reference, and in float32 with TF32 matmuls as
the comparison's control (the precision below the configuration's
float32 that a later change might be tempted by).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Dict, List

import numpy as np
import torch


@dataclasses.dataclass
class Graph:
    """Edges ``src -> dst`` of the whole graph in the generator's node
    order, on one device."""
    src: torch.Tensor    # int64 (E,)
    dst: torch.Tensor    # int64 (E,)
    n: int

    @staticmethod
    def from_csr(indptr: np.ndarray, indices: np.ndarray,
                 device) -> "Graph":
        n = indptr.shape[0] - 1
        dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        return Graph(torch.from_numpy(indices.astype(np.int64)).to(device),
                     torch.from_numpy(dst).to(device), n)

    def in_degree(self, dtype) -> torch.Tensor:
        deg = torch.zeros(self.n, dtype=dtype, device=self.dst.device)
        deg.index_add_(0, self.dst, torch.ones_like(self.dst, dtype=dtype))
        return deg.clamp_min(1.0)


def family(model: str):
    return importlib.import_module(f"perfbench.reference.{model}")


@contextlib.contextmanager
def precision(tf32: bool):
    """TF32 matmuls on or off while the block runs (restored after)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _params(weights: Dict[str, torch.Tensor], n_layers: int, dtype,
            grad: bool) -> List[Dict[str, torch.Tensor]]:
    """``{"<layer>.<name>": tensor}`` as one dict per layer, in ``dtype``."""
    out = [dict() for _ in range(n_layers)]
    for key, t in weights.items():
        i, name = key.split(".", 1)
        out[int(i)][name] = t.detach().to(dtype).clone().requires_grad_(grad)
    return out


def loss_fn(logits: torch.Tensor, labels: torch.Tensor,
            half_batch: bool = False) -> torch.Tensor:
    """Mean cross-entropy over every node (with ``half_batch``, a fault
    for the comparison's calibration: over the even nodes only)."""
    ll = torch.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    return -(ll[::2] if half_batch else ll).mean()


def train_readings(config: dict, inputs, optim: dict, steps: int, device,
                   dtype=torch.float64, tf32: bool = False,
                   half_batch: bool = False) -> dict:
    """``steps`` full-graph AdamW steps from the inputs' weights: each
    step's loss, every leaf's norm of the first gradient and of the
    parameters' change after the ``steps`` steps (``{"<layer>.<name>":
    norm}``)."""
    fam = family(config["model"])
    n_layers = len(config["dims"]) - 1
    graph = Graph.from_csr(inputs.indptr, inputs.indices, device)
    x = torch.from_numpy(inputs.x).to(device=device, dtype=dtype)
    y = torch.from_numpy(inputs.y.astype(np.int64)).to(device)
    params = _params(inputs.weights, n_layers, dtype, grad=True)
    p0 = {f"{i}.{k}": v.detach().clone()
          for i, layer in enumerate(params) for k, v in layer.items()}
    keys = list(p0)
    flat = [params[int(k.split(".", 1)[0])][k.split(".", 1)[1]]
            for k in keys]
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    b1, b2, eps = optim["b1"], optim["b2"], optim["eps"]
    lr, wd = optim["lr"], optim["weight_decay"]
    losses, grad1 = [], {}
    with precision(tf32):
        for t in range(1, steps + 1):
            loss = loss_fn(fam.forward(params, x, graph, config), y,
                           half_batch)
            grads = torch.autograd.grad(loss, flat)
            losses.append(loss.item())
            if t == 1:
                grad1 = {k: float(g.norm()) for k, g in zip(keys, grads)}
            with torch.no_grad():
                for p, g, mi, vi in zip(flat, grads, m, v):
                    mi.mul_(b1).add_((1 - b1) * g)
                    vi.mul_(b2).add_((1 - b2) * g * g)
                    upd = (mi / (1 - b1 ** t)) / (
                        (vi / (1 - b2 ** t)).sqrt() + eps)
                    p.sub_(lr * (upd + wd * p))
            del loss, grads
    change = {k: float((p.detach() - p0[k]).norm())
              for k, p in zip(keys, flat)}
    return {"losses": losses, "grad1": grad1, "change": change}


def embeddings(config: dict, inputs, device, dtype=torch.float64,
               tf32: bool = False) -> np.ndarray:
    """The last layer's output for every node, in the generator's order."""
    fam = family(config["model"])
    n_layers = len(config["dims"]) - 1
    graph = Graph.from_csr(inputs.indptr, inputs.indices, device)
    x = torch.from_numpy(inputs.x).to(device=device, dtype=dtype)
    params = _params(inputs.weights, n_layers, dtype, grad=False)
    with precision(tf32), torch.no_grad():
        out = fam.forward(params, x, graph, config)
    return out.double().cpu().numpy()
