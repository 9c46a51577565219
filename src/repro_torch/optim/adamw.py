"""AdamW and SGD as plain functions on trees of tensors (the reference's
``optim/adamw.py``).

Parameters are a tree (``repro_torch.tree``): an ``nn.ModuleList`` of layers,
a module, or nested dicts/lists of tensors. Gradients and the optimizer
state's ``m``/``v`` mirror it leaf for leaf, in traversal order — the
engine's grads (one ``{param_name: tensor}`` dict per layer) match a
``ModuleList``'s ``state_dict`` order. The updates are functional: they
return new parameters (a module comes back as an updated deep copy) and new
state, and leave their inputs unchanged. :func:`adamw_update_` applies the
same update in place, one leaf at a time, for models whose parameters and
moments cannot be held twice (the reference's train steps donate them).

The arithmetic is the reference's, in its order, not ``torch.optim.AdamW``
(whose decoupled decay and denominator round differently): the bias
corrections are float32 tensor math on the int32 step, as in JAX.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

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


def _corrections(state, b1, b2):
    """The next step and its float32 bias corrections ``1 - b ** t``."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    return step, 1.0 - b1 ** t, 1.0 - b2 ** t


def _leaf_step_(g, p, m, v, c1, c2, lr, b1, b2, eps, weight_decay):
    """One leaf's AdamW step: overwrites the float32 ``m`` and ``v`` with
    their new values and returns the new parameter in float32, leaving
    ``p`` unchanged. Its temporaries are at most three of the leaf's
    size."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        # a gradient spread over a mesh, in its parameter's placements
        g = g.redistribute(p.device_mesh, p.placements)
    g32 = g.to(torch.float32)
    m.mul_(b1).add_((1 - b1) * g32)
    v.mul_(b2).add_((1 - b2) * g32 * g32)
    del g32
    upd = (m / c1).div_((v / c2).sqrt_().add_(eps))
    p32 = p.to(torch.float32)
    if weight_decay:
        upd.add_(weight_decay * p32)
    return p32 - upd.mul_(lr)


def adamw_update(
    grads, params, state,
    lr=1e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
):
    step, c1, c2 = _corrections(state, b1, b2)
    ps, (gs, ms, vs) = _zip_leaves(params, grads, state["m"], state["v"])
    new_p, new_m, new_v = {}, {}, {}
    with torch.no_grad():
        for (key, p), g, m, v in zip(ps, gs, ms, vs):
            new_m[key], new_v[key] = m.clone(), v.clone()
            new_p[key] = _leaf_step_(
                g, p, new_m[key], new_v[key], c1, c2, lr, b1, b2, eps,
                weight_decay).to(p.dtype)
    m_keys = [k for k, _ in leaves(state["m"])]
    v_keys = [k for k, _ in leaves(state["v"])]
    keys = [k for k, _ in ps]
    return rebuild(params, new_p), {
        "m": rebuild(state["m"], dict(zip(m_keys, (new_m[k] for k in keys)))),
        "v": rebuild(state["v"], dict(zip(v_keys, (new_v[k] for k in keys)))),
        "step": step,
    }


def adamw_update_(
    grads, params, state,
    lr=1e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
):
    """:func:`adamw_update` in place: each parameter, ``m`` and ``v`` leaf
    is overwritten by :func:`_leaf_step_`, the arithmetic
    ``adamw_update`` runs on copies of ``m`` and ``v``, and
    ``state["step"]`` replaced; returns ``(params, state)``, the same
    objects. The results are bitwise ``adamw_update``'s; the leaves go one
    at a time, so the float32 temporaries are one leaf's, never the
    tree's."""
    step, c1, c2 = _corrections(state, b1, b2)
    ps, (gs, ms, vs) = _zip_leaves(params, grads, state["m"], state["v"])
    with torch.no_grad():
        for (_, p), g, m, v in zip(ps, gs, ms, vs):
            p.copy_(_leaf_step_(g, p, m, v, c1, c2, lr, b1, b2, eps,
                                weight_decay))
    state["step"] = step
    return params, state


def sgd_update(grads, params, lr=1e-2):
    ps, (gs,) = _zip_leaves(params, grads)
    with torch.no_grad():
        new = {
            key: (p.to(torch.float32) - lr * g.to(torch.float32)).to(p.dtype)
            for (key, p), g in zip(ps, gs)
        }
    return rebuild(params, new)
