"""Faults planted under the timed path, for the check that the comparison
sees them (``test_perfbench_faults.py``): each patches the program in this
process only while its block runs."""
from __future__ import annotations

import contextlib
import dataclasses


@contextlib.contextmanager
def state_unchanged():
    """Every optimizer step hands back the parameters and state it got."""
    from repro_torch import optim

    orig = optim.adamw_update
    optim.adamw_update = lambda grads, params, state, **kw: (params, state)
    try:
        yield
    finally:
        optim.adamw_update = orig


@contextlib.contextmanager
def half_batch():
    """The loss over every other node of a unit only, the mean taken over
    those."""
    from repro_torch.core.engine import SSOEngine

    orig = SSOEngine.__dict__["_loss_grad"]

    def loss_grad(logits, labels, n_total):
        labels = labels.clone()
        labels[1::2] = -1
        return orig.__func__(logits, labels, n_total / 2)

    SSOEngine._loss_grad = staticmethod(loss_grad)
    try:
        yield
    finally:
        SSOEngine._loss_grad = orig


@contextlib.contextmanager
def answer_altered(model: str, share: float = 1e-2):
    """The output layer's first row of every unit is moved by ``share`` of
    its largest entry where the layer produces it."""
    from repro_torch.models.gnn import layers

    spec = layers.GNN_REGISTRY[model]
    apply = spec.apply_layer

    def altered(layer, ga, topo, activate=True, **kw):
        out = apply(layer, ga, topo, activate=activate, **kw)
        if not activate:
            out = out.clone()
            out[0] += share * out[0].abs().max().detach()
        return out

    layers.GNN_REGISTRY[model] = dataclasses.replace(spec,
                                                     apply_layer=altered)
    try:
        yield
    finally:
        layers.GNN_REGISTRY[model] = spec
