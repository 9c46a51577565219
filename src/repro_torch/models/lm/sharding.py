"""Parameter, batch and KV-cache placement rules for a ``("data",
"model")`` mesh (the reference's ``models/lm/sharding.py``).

A *spec* is the reference's ``PartitionSpec`` as a tuple: entry ``i`` names
the mesh dim (or a tuple of them) tensor dim ``i`` is split over, or is
None. :func:`placements` turns a spec into one ``Shard`` / ``Replicate``
placement per mesh dim of a ``DeviceMesh``, the form the registry's builds
hand out.

The rules are the reference's: ``best_spec`` greedily gives the mesh dims
to the largest divisible tensor dims; with ``megatron_rules`` the named
leaves take the Megatron + FSDP layouts of ``_NAME_RULES``; expert weights
take ``_EXPERT_RULES`` where the expert axis shards. The reference stacks
each layer's leaves along a leading L axis and never shards it; the port
holds one module a layer, so :func:`param_specs` gives ``layers.<i>.<name>``
the reference's spec of the stacked leaf with its L entry dropped.

The reference's ``constrain`` (a GSPMD hint pinning an activation's
sharding inside a jitted step) has no counterpart: the port's steps run
eagerly on each rank's local shard, and on one card it is the identity.
``param_shardings`` (``NamedSharding``s) waits for the dry run.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import axis_size, data_axes

Spec = Tuple


def _sizes(mesh) -> Dict[str, int]:
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


def placements(mesh, spec: Spec) -> tuple:
    """One placement per mesh dim: ``Shard(i)`` for the first tensor dim
    ``i`` whose spec entry names that mesh dim, else ``Replicate()``."""
    out = []
    for a in mesh.mesh_dim_names:
        dims = [i for i, s in enumerate(spec)
                if s == a or (isinstance(s, tuple) and a in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def replicated(mesh) -> tuple:
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def best_spec(shape, mesh, skip_leading: bool = False,
              axes=("model", "data")) -> Spec:
    """Assign mesh dims to tensor dims, largest divisible dim first; with
    ``skip_leading`` (and more than one dim) the leading dim is never
    assigned (a stacked L axis)."""
    sizes = _sizes(mesh)
    ndim = len(shape)
    start = 1 if (skip_leading and ndim > 1) else 0
    assign = {}
    order = sorted(range(start, ndim), key=lambda i: -shape[i])
    for ax in axes:
        if ax not in sizes:
            continue
        n = sizes[ax]
        for i in order:
            if i not in assign and shape[i] % n == 0 and shape[i] >= n:
                assign[i] = ax
                break
    return tuple(assign.get(i) for i in range(ndim))


EXPERT_LEAVES = ("w_gate", "w_up", "w_down")

# Megatron + FSDP layouts, keyed by leaf name: (mesh dim, tensor dim of the
# unstacked leaf) preferences, each taken where the dim divides. "data" on
# dim 0 of a matmul weight is ZeRO-3 (a weight all-gather); "model" goes on
# the heads / ff output dims (tensor parallelism).
_NAME_RULES = {
    # attention projections (d, H, e): FSDP on d, TP on heads
    "wq": (("data", 0), ("model", 1)),
    "w_uq": (("data", 0), ("model", 1)),
    # KV projections: FSDP only (no GQA head-count divisibility issue)
    "wk": (("data", 0),),
    "wv": (("data", 0),),
    "w_uk": (("data", 0), ("model", 1)),
    "w_uv": (("data", 0), ("model", 1)),
    "w_dq": (("data", 0),),
    "w_dkv": (("data", 0),),
    "w_kr": (("data", 0),),
    # out-projection (H, e, d): TP on heads
    "wo": (("model", 0), ("data", 2)),
    "w_o": (("model", 0), ("data", 2)),
    # shared FFN (d, ff) / (ff, d): TP on ff, FSDP on d
    "shared_gate": (("data", 0), ("model", 1)),
    "shared_up": (("data", 0), ("model", 1)),
    "shared_down": (("model", 0), ("data", 1)),
    "embed": (("model", 0), ("data", 1)),
    "lm_head": (("data", 0), ("model", 1)),
    "router": (),
}
# MoE expert weights (E, d, ff) / (E, ff, d): experts over data, TP on the
# other dim
_EXPERT_RULES = {
    "w_gate": (("data", 0), ("model", 1)),
    "w_up": (("data", 0), ("model", 1)),
    "w_down": (("data", 0), ("model", 2)),
}


def leaf_spec(name: str, shape, mesh, stacked: bool,
              megatron_rules: bool) -> Spec:
    """The reference's spec of one leaf: ``shape`` with a leading L axis
    when ``stacked`` (the spec then has an entry for it, always None)."""
    sizes = _sizes(mesh)
    off = 1 if stacked else 0
    if len(shape) <= 1:
        return ()

    def apply_rules(rules):
        spec = [None] * len(shape)
        for ax, dim in rules:
            i = dim + off
            n = sizes.get(ax, 1)
            if i < len(shape) and spec[i] is None and shape[i] % n == 0 \
                    and shape[i] >= n:
                spec[i] = ax
        return tuple(spec)

    if name in _EXPERT_RULES and len(shape) - off == 3:
        spec = apply_rules(_EXPERT_RULES[name])
        # the expert layout only where the expert dim really shards
        if spec[off] == "data":
            return spec
    if megatron_rules and name in _NAME_RULES:
        return apply_rules(_NAME_RULES[name])
    return best_spec(shape, mesh, skip_leading=stacked)


def param_specs(model, mesh, megatron_rules: Optional[bool] = None
                ) -> Dict[str, tuple]:
    """``{parameter name: placements}`` of an LM (any device, ``meta``
    included). ``layers.<i>.<leaf>`` gets the spec of the reference's leaf
    stacked over the model's layers, its L entry dropped. The reference's
    expert rules always apply; its Megatron attention rules apply when
    ``megatron_rules`` is true, by default when the environment sets
    ``REPRO_MEGATRON=1``, as the reference reads it."""
    if megatron_rules is None:
        megatron_rules = os.environ.get("REPRO_MEGATRON", "0") == "1"
    n_layers = len(model.layers)
    out = {}
    for key, p in model.named_parameters():
        stacked = key.startswith("layers.")
        shape = tuple(p.shape)
        spec = leaf_spec(key.rsplit(".", 1)[-1],
                         (n_layers,) + shape if stacked else shape,
                         mesh, stacked, megatron_rules)
        out[key] = placements(mesh, spec[1:] if stacked else spec)
    return out


def batch_spec(batch: int, mesh) -> Spec:
    """The data dims a batch of ``batch`` rows splits over: all of them
    where ``batch`` divides, else the longest prefix that does, else none
    (the reference's ``batch_spec``; the spec of dim 0)."""
    axes = data_axes(mesh)
    for k in range(len(axes), 0, -1):
        if batch % axis_size(mesh, axes[:k]) == 0:
            return (axes[:k],)
    return (None,)


def kv_cache_specs(cache: Dict, mesh, batch: int) -> Dict[str, tuple]:
    """The caches of ``init_kv_cache`` (``(L, B, S, ...)``: GQA's ``{"k",
    "v"}``, MLA's ``{"ckv", "kr"}``): batch over the
    data dims where it divides, the sequence over ``"model"``; at a batch
    that does not divide, the sequence over every dim. Returns placements per
    cache; a cache with fewer than 3 dims or no layers is replicated."""
    bspec = batch_spec(batch, mesh)
    seq_axes = (("model",) if bspec != (None,) else tuple(
        a for a in ("pod", "data", "model") if a in mesh.mesh_dim_names))

    def leaf(x):
        if x.dim() < 3 or x.shape[0] == 0:
            return replicated(mesh)
        spec = [None] * x.dim()
        spec[1] = bspec[0]
        spec[2] = seq_axes if len(seq_axes) > 1 else seq_axes[0]
        return placements(mesh, spec)

    return {k: leaf(x) for k, x in cache.items()}
