"""Weight converters between the reference (JAX) parameter pytrees and the
port's layers, both ways.

The tests use them to hand both packages the same weights and to compare
gradients and trained weights; ``chip_smoke.py`` never imports JAX and
initialises from a seeded ``torch.Generator`` instead. The reference side is
plain numpy dictionaries (``np.asarray`` of the reference params), so this
module needs nothing of JAX.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn.layers import GCNLayer


def params_from_jax(params: List[Dict], device: DeviceLike = None) -> nn.ModuleList:
    """``[{"lin": {"w": (d_in, d_out), "b": (d_out,)}}, ...]`` -> GCN layers
    with ``lin.weight = w.T`` and ``lin.bias = b``, on ``device``."""
    device = resolve_device(device)
    layers = []
    for i, p in enumerate(params):
        if set(p) != {"lin"}:
            raise ValueError(
                f"layer {i}: only GCN params ({{'lin': {{'w', 'b'}}}}) are "
                f"ported; got keys {sorted(p)}"
            )
        w = np.array(p["lin"]["w"], np.float32)
        b = np.array(p["lin"]["b"], np.float32)
        if w.ndim != 2 or b.shape != (w.shape[1],):
            raise ValueError(
                f"layer {i}: w {w.shape} and b {b.shape} do not form a "
                "(d_in, d_out) dense layer"
            )
        layer = GCNLayer(w.shape[0], w.shape[1], device=device,
                         generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            layer.lin.weight.copy_(torch.from_numpy(w.T.copy()))
            layer.lin.bias.copy_(torch.from_numpy(b))
        layers.append(layer)
    return nn.ModuleList(layers)


def _lin_to_jax(weight: torch.Tensor, bias: torch.Tensor) -> Dict:
    w = weight.detach().cpu().numpy()
    return {"lin": {"w": np.ascontiguousarray(w.T),
                    "b": bias.detach().cpu().numpy().copy()}}


def params_to_numpy(params) -> List[Dict]:
    """GCN layers -> ``[{"lin": {"w": (d_in, d_out), "b": (d_out,)}}, ...]``
    numpy, the reference's layout (the inverse of :func:`params_from_jax`)."""
    return [_lin_to_jax(layer.lin.weight, layer.lin.bias) for layer in params]


def grads_to_jax(grads: List[Dict[str, torch.Tensor]]) -> List[Dict]:
    """The engine's per-layer ``{"lin.weight", "lin.bias"}`` gradients ->
    the reference's ``[{"lin": {"w", "b"}}, ...]`` numpy layout."""
    out = []
    for i, g in enumerate(grads):
        if set(g) != {"lin.weight", "lin.bias"}:
            raise ValueError(
                f"layer {i}: only GCN grads ('lin.weight', 'lin.bias') are "
                f"ported; got keys {sorted(g)}"
            )
        out.append(_lin_to_jax(g["lin.weight"], g["lin.bias"]))
    return out
