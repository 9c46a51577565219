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

:func:`param_shardings` is the reference's ``NamedSharding`` tree: ``{name:
(mesh, placements)}``; :func:`distribute_params` swaps a model's
parameters for ``DTensor``s of those placements, as the dry run gives an
LM or recsys step its arguments. :func:`constrain` is the reference's
activation pin: on a ``DTensor`` it redistributes to the named dims (the
one way DTensor's propagation, standing in for GSPMD's, is kept in ZeRO-3
mode: weights gathered, the batch kept split); on a plain tensor, the
eager path on one card, it returns its argument itself.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import (
    DTensor, Placement, Replicate, Shard, distribute_tensor,
)

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


def param_shardings(model, mesh, megatron_rules: Optional[bool] = None
                    ) -> Dict[str, tuple]:
    """``{parameter name: (mesh, placements)}``: :func:`param_specs` with its
    mesh, the counterpart of the reference's ``NamedSharding`` tree."""
    return {k: (mesh, pl) for k, pl in
            param_specs(model, mesh, megatron_rules).items()}


def distribute_params(model, mesh, shardings: Optional[Dict] = None):
    """Replace each of ``model``'s parameters, in place, by
    ``distribute_tensor`` of its placements (``shardings``: a ``{name:
    placements}`` dict, :func:`param_specs` by default), keeping its
    ``requires_grad``. Returns ``model``."""
    shardings = param_specs(model, mesh) if shardings is None else shardings
    for key, p in list(model.named_parameters()):
        owner, _, leaf = key.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        d = distribute_tensor(p.detach(), mesh, shardings[key])
        setattr(mod, leaf,
                torch.nn.Parameter(d, requires_grad=p.requires_grad))
    return model


DB = ("pod", "data")  # batch dims


def constrain_spec(shape, mesh, names) -> Spec:
    """The reference's rule for one pin: ``names`` per dim (None, a dim
    name or a tuple of them); a dim that does not divide the named dims'
    size, or is smaller, is left unsharded, and a name the mesh lacks is
    dropped."""
    sizes = _sizes(mesh)
    spec = []
    for dim, nm in zip(shape, names):
        cand = () if nm is None else (nm if isinstance(nm, tuple) else (nm,))
        axes = tuple(a for a in cand if a in sizes)
        n = 1
        for a in axes:
            n *= sizes[a]
        spec.append((axes if len(axes) > 1 else axes[0])
                    if axes and dim % n == 0 and dim >= n else None)
    return tuple(spec) + (None,) * (len(shape) - len(spec))


def constrain(x, *names):
    """Pin an activation's placements (the reference's ``constrain``).
    A ``DTensor`` is redistributed over its mesh to :func:`constrain_spec`
    of its global shape (a partial sum is reduced on the way); any other
    tensor comes back as it is, the same object, so the eager path on one
    card is unchanged bitwise."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    want = placements(mesh, constrain_spec(x.shape, mesh, names))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def unshard_dims(x, dims):
    """A ``DTensor`` with its ``Shard`` placements on ``dims`` made
    ``Replicate`` (an all-gather), for an op DTensor cannot run well on
    that split (a reshape merging a split dim into the one before it, a
    normalisation over it); any other tensor comes back as it is."""
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.dim() for d in dims}
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p
                 for p in x.placements)
    if want == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def rows_of(x, outer: int):
    """``x`` ``(outer * k, ...)`` ready for a view to ``(outer, k * ...)``:
    a ``DTensor`` keeps its split of dim 0 over the mesh dims whose sizes'
    product still divides ``outer`` and is gathered everywhere else; any
    other tensor comes back as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh, want, n = x.device_mesh, [], 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == 0 and \
                outer % (n * mesh.size(i)) == 0:
            n *= mesh.size(i)
            want.append(p)
        else:
            want.append(Replicate())
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(mesh, tuple(want))


def head_placements(q, n_kv_heads: int) -> tuple:
    """Attention's per-rank split of ``q`` ``(B, S, H, D)`` (a ``DTensor``):
    each mesh dim that splits q's batch keeps it, each that splits its
    heads keeps them while ``n_kv_heads`` still divides, the sequence and
    the rest are whole."""
    mesh, out, n = q.device_mesh, [], 1
    for i, p in enumerate(q.placements):
        if isinstance(p, Shard) and p.dim == 0:
            out.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 2 and \
                n_kv_heads % (n * mesh.size(i)) == 0:
            n *= mesh.size(i)
            out.append(Shard(2))
        else:
            out.append(Replicate())
    return tuple(out)


def on_shards(fn, args, in_placements, out_placements,
              grad_placements=None):
    """``fn(*args)`` run on each rank's local shards (``local_map``):
    ``args`` redistributed to ``in_placements`` (one tuple each, None for a
    non-tensor), the outputs taken as ``out_placements``' DTensors, the
    inputs' gradients as ``grad_placements``' (``in_placements`` by
    default; a replicated input read by a split computation gets a partial
    sum). Where no argument is a ``DTensor`` it is ``fn(*args)``."""
    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    if all(isinstance(p, Placement) for p in out_placements):
        out_placements = list(out_placements)      # one output
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(in_placements),
                     in_grad_placements=(None if grad_placements is None
                                         else tuple(grad_placements)),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def seq_dims(cache) -> tuple:
    """The mesh dims that split a ``(B, S, ...)`` cache's sequence (dim 1),
    in mesh order; none for a plain tensor."""
    if not isinstance(cache, DTensor):
        return ()
    return tuple(a for a, p in zip(cache.device_mesh.mesh_dim_names,
                                   cache.placements)
                 if isinstance(p, Shard) and p.dim == 1)


def write_position(cache, pos: int, row) -> None:
    """``cache[:, pos] = row`` (``row`` ``(B, ...)``, cast to the cache's
    dtype). On a ``DTensor`` cache the rank whose sequence shard holds
    ``pos`` writes it into its local shard, the batch split as the
    cache's."""
    if not isinstance(cache, DTensor):
        cache[:, pos] = row.to(cache.dtype)
        return
    mesh = cache.device_mesh
    pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in cache.placements)
    loc = cache.to_local()
    # this rank's first position: its place along the split dims, the
    # first major
    off = 0
    for a in seq_dims(cache):
        off = off * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    off *= loc.shape[1]
    if off <= pos < off + loc.shape[1]:
        r = row.redistribute(mesh, pl).to_local() if isinstance(
            row, DTensor) else row
        loc[:, pos - off] = r.to(loc.dtype)


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
