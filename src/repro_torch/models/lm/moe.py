"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch
(the reference's ``models/lm/moe.py``).

Tokens split into ``groups`` contiguous groups; each group routes its own
tokens (float32 router, top-k, softmax over the k picked logits) and fills
each expert's queue up to a capacity ``C`` in token-major, k-minor order,
dropping the assignments past it. The reference ``vmap``s the dispatch
over the groups; here every group's queue for expert ``e`` sits side by
side in one ``(E, G * C, d)`` buffer, so each expert's weights are read
once per call by one batched matrix product, not once per group. The rows
are independent, so the arithmetic is the reference's.

No float atomics: a kept assignment's slot in the buffer is unique, so the
dispatch is an ``index_put`` without accumulation (the dropped ones all
land in one overflow row that is discarded), the token copies come from an
``expand`` (whose gradient is a sum, not a scatter), and a token's K
results are summed over a ``(T, K, d)`` view. Two calls on the same
inputs, and their gradients, are bitwise equal.

Over ``DTensor``s (the dry run) the FFN runs rank by rank: each rank
routes its own token groups (``groups`` divided by the ranks that split
the tokens, so every group is the one-card group) through every expert's
gathered weights (the shared experts' too), the ZeRO-3 layout; the reference's
``REPRO_MOE_CONSTRAIN=1`` pins the tokens' split over the batch dims
first. On one card both are the identity.
"""
from __future__ import annotations

import dataclasses
import math
import os
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.lm.layers import swiglu
from repro_torch.models.lm.sharding import DB, constrain, on_shards


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0         # total shared-expert hidden dim
    capacity_factor: float = 1.25
    first_dense: int = 0         # leading layers that use a dense FFN
    d_ff_dense: int = 0          # hidden dim of those dense layers
    # token groups for dispatch: routing and capacity are per group
    groups: int = 32

    @property
    def d_ff_shared_total(self) -> int:
        """The shared experts' hidden width (0 without shared experts)."""
        if not self.n_shared:
            return 0
        return self.d_ff_shared or self.n_shared * self.d_ff_expert


def moe_shape(mcfg: MoEConfig, n_tokens: int) -> Tuple[int, int]:
    """``(G, C)``: the groups ``n_tokens`` tokens split into (``groups``
    clipped to the tokens, lowered until it divides them) and each
    expert's capacity per group."""
    T = n_tokens
    G = max(min(mcfg.groups, T), 1)
    while T % G:
        G -= 1
    C = int(math.ceil((T // G) * mcfg.top_k / mcfg.n_experts
                      * mcfg.capacity_factor))
    return G, max(C, 4)


def moe_param_shapes(d_model: int, mcfg: MoEConfig) -> Dict[str, tuple]:
    """The reference's leaves of one MoE FFN and their shapes, in its
    initialisation order: ``router (d, E)`` (float32 whatever the model's
    dtype), the experts' ``w_gate`` / ``w_up`` ``(E, d, ff)`` and
    ``w_down`` ``(E, ff, d)``, and with shared experts ``shared_gate`` /
    ``shared_up`` ``(d, ffs)`` and ``shared_down`` ``(ffs, d)``."""
    E, ff, d = mcfg.n_experts, mcfg.d_ff_expert, d_model
    out = {"router": (d, E), "w_gate": (E, d, ff), "w_up": (E, d, ff),
           "w_down": (E, ff, d)}
    ffs = mcfg.d_ff_shared_total
    if ffs:
        out.update(shared_gate=(d, ffs), shared_up=(d, ffs),
                   shared_down=(ffs, d))
    return out


def moe_ffn(p, x: torch.Tensor, mcfg: MoEConfig,
            experts: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` ``(T, d)`` token-major -> ``(y (T, d) in x's dtype, aux)``.
    ``p`` holds the leaves of :func:`moe_param_shapes` as attributes (an
    ``LMBlock``). ``aux`` is the float32 0-d Switch-style load-balancing
    loss, ``E * sum(mean softmax * assignment share)`` per group (dropped
    assignments counted), averaged over the groups. ``experts`` ``(T, K)``
    routes each token to those experts in that order instead of its top
    k, its gates the softmax of its router logits there: two computations
    of the same tokens held on the same routes."""
    if isinstance(x, DTensor):
        return _moe_on_shards(p, x, mcfg, experts)
    T, d = x.shape
    E, K = mcfg.n_experts, mcfg.top_k
    G, C = moe_shape(mcfg, T)
    Tg, N = T // G, (T // G) * K
    dev = x.device

    logits = torch.matmul(x.float().reshape(G, Tg, d), p.router)
    if experts is None:
        topv, topi = torch.topk(logits, K, dim=-1)      # (G, Tg, K)
    else:
        topi = experts.reshape(G, Tg, K)
        topv = torch.gather(logits, -1, topi)
    gates = torch.softmax(topv, dim=-1)                 # over the top k

    # each (token, k)'s place in its expert's queue: its rank among the
    # group's earlier assignments to that expert (a stable sort)
    flat_e = topi.reshape(G, N)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    rank = torch.arange(N, device=dev) - torch.searchsorted(sorted_e,
                                                            sorted_e)
    pos = torch.empty_like(flat_e).scatter_(1, order, rank)
    keep = pos < C
    slot = (flat_e * (G * C) + torch.arange(G, device=dev)[:, None] * C
            + pos)
    dest = torch.where(keep, slot, E * G * C).reshape(-1)   # overflow E*G*C

    # dispatch: (E * G * C + 1, d), the last row the discarded overflow
    src = x.unsqueeze(1).expand(T, K, d).reshape(T * K, d)
    xe = x.new_zeros((E * G * C + 1, d)).index_put((dest,), src)
    xe = xe[:E * G * C].view(E, G * C, d)

    g = torch.bmm(xe, p.w_gate)
    u = torch.bmm(xe, p.w_up)
    ye = torch.bmm(F.silu(g) * u, p.w_down)             # (E, G * C, d)

    # combine, each kept assignment weighted by its gate
    ye_flat = torch.cat([ye.reshape(E * G * C, d), ye.new_zeros((1, d))])
    w = (gates.reshape(-1, 1).to(ye.dtype)
         * keep.reshape(-1, 1).to(ye.dtype))
    y = (ye_flat[dest] * w).view(T, K, d).sum(dim=1)

    # load-balancing loss: the softmax's mean and the assignment shares
    me = torch.softmax(logits, dim=-1).mean(dim=1)                # (G, E)
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    counts = (torch.searchsorted(sorted_e, experts, right=True)
              - torch.searchsorted(sorted_e, experts))
    ce = counts.float() / (Tg * K)
    aux = (E * (me * ce).sum(dim=-1)).mean()

    if mcfg.n_shared:
        y = y + swiglu(x, p.shared_gate, p.shared_up, p.shared_down)
    return y, aux



def _moe_on_shards(p, x, mcfg: MoEConfig, experts=None):
    """:func:`moe_ffn` over a ``DTensor`` ``x``, rank by rank (see the
    module's docstring), the shared experts too. The aux loss is each
    rank's mean over its groups, averaged over the ranks."""
    pin = os.environ.get("REPRO_MOE_CONSTRAIN", "0") == "1"
    if pin:
        x = constrain(x, DB, None)
    mesh, T = x.device_mesh, x.shape[0]
    G, _ = moe_shape(mcfg, T)
    split = [i for i, q in enumerate(x.placements)
             if isinstance(q, Shard) and q.dim == 0]
    n = 1
    for i in split:
        n *= mesh.size(i)
    if G % n:
        split, n = [], 1
    xpl = tuple(Shard(0) if i in split else Replicate()
                for i in range(mesh.ndim))
    apl = tuple(Partial("avg") if i in split else Replicate()
                for i in range(mesh.ndim))
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    local = dataclasses.replace(mcfg, groups=G // n)
    names = tuple(moe_param_shapes(x.shape[1], mcfg))

    def routed(xl, *ws):
        return moe_ffn(SimpleNamespace(**dict(zip(names, ws))), xl, local,
                       experts=None if experts is None else ws[-1])

    ws = [getattr(p, k) for k in names]
    args = (x, *ws) + (() if experts is None else (experts,))
    y, aux = on_shards(routed, args,
                       (xpl,) + (rep,) * (len(args) - 1), (xpl, apl))
    if pin:
        y = constrain(y, DB, None)
    return y, aux
