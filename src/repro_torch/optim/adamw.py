"""AdamW and SGD as plain functions on trees of tensors (the reference's
``optim/adamw.py``).

Parameters are a tree (``repro_torch.tree``): an ``nn.ModuleList`` of layers,
a module, or nested dicts/lists of tensors. Gradients and the optimizer
state's ``m``/``v`` mirror it leaf for leaf, in traversal order — the
engine's grads (one ``{param_name: tensor}`` dict per layer) match a
``ModuleList``'s ``state_dict`` order. The updates are functional: they
return new parameters (a module comes back as an updated deep copy) and new
state, and leave their inputs unchanged.

The arithmetic is the reference's, in its order, not ``torch.optim.AdamW``
(whose decoupled decay and denominator round differently): the bias
corrections are float32 tensor math on the int32 step, as in JAX.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, plain, rebuild


def _first_device(params) -> torch.device:
    for _, leaf in leaves(params):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def adamw_init(params):
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {
        "m": plain(params, zeros),
        "v": plain(params, zeros),
        "step": torch.zeros((), dtype=torch.int32,
                            device=_first_device(params)),
    }


def _zip_leaves(params, *trees):
    ps = leaves(params)
    others = [[leaf for _, leaf in leaves(t)] for t in trees]
    for o in others:
        if len(o) != len(ps):
            raise ValueError(
                f"tree has {len(o)} leaves, parameters have {len(ps)}"
            )
    return ps, others


def adamw_update(
    grads, params, state,
    lr=1e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
):
    step = state["step"] + 1
    t = step.to(torch.float32)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    ps, (gs, ms, vs) = _zip_leaves(params, grads, state["m"], state["v"])
    new_p, new_m, new_v = {}, {}, {}
    with torch.no_grad():
        for (key, p), g, m, v in zip(ps, gs, ms, vs):
            g32 = g.to(torch.float32)
            p32 = p.to(torch.float32)
            m_new = b1 * m + (1 - b1) * g32
            v_new = b2 * v + (1 - b2) * g32 * g32
            upd = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p32
            new_p[key] = (p32 - lr * upd).to(p.dtype)
            new_m[key], new_v[key] = m_new, v_new
    m_keys = [k for k, _ in leaves(state["m"])]
    v_keys = [k for k, _ in leaves(state["v"])]
    keys = [k for k, _ in ps]
    return rebuild(params, new_p), {
        "m": rebuild(state["m"], dict(zip(m_keys, (new_m[k] for k in keys)))),
        "v": rebuild(state["v"], dict(zip(v_keys, (new_v[k] for k in keys)))),
        "step": step,
    }


def sgd_update(grads, params, lr=1e-2):
    ps, (gs,) = _zip_leaves(params, grads)
    with torch.no_grad():
        new = {
            key: (p.to(torch.float32) - lr * g.to(torch.float32)).to(p.dtype)
            for (key, p), g in zip(ps, gs)
        }
    return rebuild(params, new)
