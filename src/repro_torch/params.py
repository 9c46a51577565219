"""Weight converters between the reference (JAX) parameter pytrees and the
port's layers, both ways, for the six GNN families, the two-tower model and
the dense LM.

The tests use them to hand both packages the same weights and to compare
gradients and trained weights; ``chip_smoke.py`` never imports JAX and
initialises from a seeded ``torch.Generator`` instead. The reference side is
plain numpy dictionaries (``np.asarray`` of the reference params), so this
module needs nothing of JAX.

A dense sub-layer ``{"w": (d_in, d_out), "b": (d_out,)}`` is an
``nn.Linear`` with ``weight = w.T`` and ``bias = b``; any other leaf (GAT's
``w``/``a_src``/``a_dst``/``b``, GIN's 0-d ``eps``, PNA's 0-d
``log_mean_deg``) is a parameter of the same shape. :data:`LAYOUT` maps each
family's reference keys to the port's attribute names (the reference's
``self`` is the port's ``lin_self``). A layer's family is recognised from
its key set, or named with ``model=``.

The two-tower model keeps the reference's layout: its tables and its
towers' ``w (in, out)`` / ``b`` are parameters of the same shapes and names
(``user_mlp.<i>.w`` for ``params["user_mlp"][i]["w"]``).

The LM keeps the reference's einsum layouts and leaf names too; the
reference stacks the layers' parameters along a leading L axis
(``params["layers"]["attn"]["wq"]`` is ``(L, d, H, Dh)``), the port holds
one :class:`~repro_torch.models.lm.transformer.LMBlock` per layer
(``layers.<i>.wq``), so the converters unstack and stack that axis
(``lm_grads_to_jax`` stacks the port's per-layer gradients the same way).
An MoE config's first dense layers are the reference's unstacked
``params["dense_layers"]`` list and the port's ``dense_layers.<i>.*``.
Each leaf keeps its own dtype (``cfg.dtype``, the MoE router float32).
bf16 arrays travel as numpy's ``bfloat16`` (``ml_dtypes``, the type
``np.asarray`` gives a JAX bf16 array), bit for bit.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.gnn.layers import GNN_REGISTRY
from repro_torch.models.lm.transformer import LM, LMConfig
from repro_torch.models.recsys.two_tower import TwoTower

# family -> ((reference key, port attribute, dense?), ...), in the port
# layer's parameter order
LAYOUT: Dict[str, Tuple[Tuple[str, str, bool], ...]] = {
    "gcn": (("lin", "lin", True),),
    "sage": (("self", "lin_self", True), ("nbr", "nbr", True)),
    "gat": (("w", "w", False), ("a_src", "a_src", False),
            ("a_dst", "a_dst", False), ("b", "b", False)),
    "gin": (("mlp1", "mlp1", True), ("mlp2", "mlp2", True),
            ("eps", "eps", False)),
    "pna": (("pre", "pre", True), ("post", "post", True),
            ("log_mean_deg", "log_mean_deg", False)),
    "graphcast": tuple((k, k, True) for k in
                       ("edge1", "edge2", "node1", "node2", "proj")),
}


def _grad_keys(model: str) -> frozenset:
    keys = set()
    for _, attr, dense in LAYOUT[model]:
        keys |= {f"{attr}.weight", f"{attr}.bias"} if dense else {attr}
    return frozenset(keys)


_BY_KEYS = {frozenset(k for k, _, _ in v): m for m, v in LAYOUT.items()}
_BY_GRAD_KEYS = {_grad_keys(m): m for m in LAYOUT}


def _family(keys, table, i: int, what: str, model: Optional[str]) -> str:
    keys = frozenset(keys)
    if model is not None:
        if model not in LAYOUT:
            raise ValueError(f"unknown GNN family {model!r} "
                             f"(one of {sorted(LAYOUT)})")
        want = next(k for k, m in table.items() if m == model)
        if keys != want:
            raise ValueError(f"layer {i}: {model} {what} have keys "
                             f"{sorted(want)}; got {sorted(keys)}")
        return model
    if keys not in table:
        raise ValueError(f"layer {i}: {what} keys {sorted(keys)} match no "
                         f"GNN family ({sorted(LAYOUT)})")
    return table[keys]


def _dense_np(p, i: int, key: str) -> Tuple[np.ndarray, np.ndarray]:
    w = np.array(p["w"], np.float32)
    b = np.array(p["b"], np.float32)
    if w.ndim != 2 or b.shape != (w.shape[1],):
        raise ValueError(
            f"layer {i} {key!r}: w {w.shape} and b {b.shape} do not form a "
            "(d_in, d_out) dense layer"
        )
    return w, b


def _dims(model: str, p: Dict) -> Tuple[int, int, dict]:
    """``(d_in, d_out, extra constructor kwargs)`` of a reference layer."""
    if model == "gat":
        d_in, n_heads, d_head = np.shape(p["w"])
        return d_in, n_heads * d_head, {"n_heads": n_heads}
    first = {"gcn": "lin", "sage": "self", "gin": "mlp1", "pna": "post",
             "graphcast": "proj"}[model]
    d_in, d_out = np.shape(p[first]["w"])
    if model == "pna":
        d_in = np.shape(p["pre"]["w"])[0]
    return d_in, d_out, {}


def params_from_jax(params: List[Dict], device: DeviceLike = None,
                    model: Optional[str] = None) -> nn.ModuleList:
    """Reference per-layer parameter dicts -> the port's layers on
    ``device``, each family recognised from its key set (or ``model``)."""
    device = resolve_device(device)
    layers = []
    for i, p in enumerate(params):
        fam = _family(p, _BY_KEYS, i, "params", model)
        d_in, d_out, kw = _dims(fam, p)
        layer = GNN_REGISTRY[fam].layer_cls(
            d_in, d_out, device=device,
            generator=torch.Generator().manual_seed(0), **kw)
        with torch.no_grad():
            for key, attr, dense in LAYOUT[fam]:
                dst = getattr(layer, attr)
                if dense:
                    w, b = _dense_np(p[key], i, key)
                    pairs = ((dst.weight, w.T), (dst.bias, b))
                else:
                    pairs = ((dst, np.array(p[key], np.float32)),)
                for t, a in pairs:
                    if tuple(t.shape) != a.shape:
                        raise ValueError(
                            f"layer {i} {key!r}: shape {a.shape} does not "
                            f"fit the {fam} layer's {tuple(t.shape)}")
                    t.copy_(torch.from_numpy(np.array(a, order="C")))
        layers.append(layer)
    return nn.ModuleList(layers)


def _to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _to_jax(model: str, get) -> Dict:
    out = {}
    for key, attr, dense in LAYOUT[model]:
        if dense:
            out[key] = {"w": np.ascontiguousarray(_to_np(get(f"{attr}.weight")).T),
                        "b": _to_np(get(f"{attr}.bias"))}
        else:
            out[key] = _to_np(get(attr))
    return out


def params_to_numpy(params, model: Optional[str] = None) -> List[Dict]:
    """The port's layers -> the reference's per-layer numpy dicts (the
    inverse of :func:`params_from_jax`)."""
    out = []
    for i, layer in enumerate(params):
        named = dict(layer.named_parameters())
        fam = _family(named, _BY_GRAD_KEYS, i, "parameters", model)
        out.append(_to_jax(fam, named.__getitem__))
    return out


def grads_to_jax(grads: List[Dict[str, torch.Tensor]],
                 model: Optional[str] = None) -> List[Dict]:
    """The engine's per-layer ``{param_name: tensor}`` gradients -> the
    reference's per-layer numpy layout."""
    out = []
    for i, g in enumerate(grads):
        fam = _family(g, _BY_GRAD_KEYS, i, "grads", model)
        out.append(_to_jax(fam, g.__getitem__))
    return out


_TOWERS = ("user_mlp", "item_mlp")
_TABLES = ("user_table", "item_table")


def two_tower_from_jax(params_np: Dict, device: DeviceLike = None) -> TwoTower:
    """The reference's two-tower params (``user_table``, ``item_table``,
    ``user_mlp`` / ``item_mlp`` lists of ``{"w", "b"}``, as numpy) -> a
    :class:`TwoTower` on ``device``."""
    device = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32, order="C")).to(device)

    return TwoTower(
        *(t(params_np[k]) for k in _TABLES),
        *([(t(l["w"]), t(l["b"])) for l in params_np[k]] for k in _TOWERS),
    )


def _two_tower_np(get, n_layers: Dict[str, int]) -> Dict:
    out = {k: _to_np(get(k)) for k in _TABLES}
    for k in _TOWERS:
        out[k] = [{"w": _to_np(get(f"{k}.{i}.w")), "b": _to_np(get(f"{k}.{i}.b"))}
                  for i in range(n_layers[k])]
    return out


def _tower_depths(names) -> Dict[str, int]:
    return {k: len({n.split(".")[1] for n in names if n.startswith(k + ".")})
            for k in _TOWERS}


def two_tower_to_numpy(model: TwoTower) -> Dict:
    """A :class:`TwoTower` -> the reference's numpy params layout (the
    inverse of :func:`two_tower_from_jax`)."""
    named = dict(model.named_parameters())
    return _two_tower_np(named.__getitem__, _tower_depths(named))


def two_tower_grads_to_jax(grads: Dict[str, torch.Tensor]) -> Dict:
    """The port's ``{parameter name: gradient}`` (``two_tower_value_and_grad``)
    -> the reference's numpy params layout."""
    return _two_tower_np(grads.__getitem__, _tower_depths(grads))


# the LMBlock leaves under the reference's layer["attn"] (GQA's and MLA's);
# the norms sit at the layer's top, every other leaf under layer["ffn"]
LM_ATTN_LEAVES = frozenset((
    "wq", "wk", "wv", "wo",
    "w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_kr", "w_uk", "w_uv",
    "w_o"))
LM_NORM_LEAVES = ("attn_norm", "ffn_norm")
LM_TOP_KEYS = ("embed", "final_norm", "lm_head")
LM_GROUPS = ("layers", "dense_layers")


def lm_leaf_path(attr: str) -> Tuple[str, ...]:
    """An :class:`~repro_torch.models.lm.transformer.LMBlock` leaf's key
    path inside one of the reference's layers (``("attn", "wq")``,
    ``("ffn", "router")``, ``("attn_norm",)``)."""
    if attr in LM_NORM_LEAVES:
        return (attr,)
    return ("attn" if attr in LM_ATTN_LEAVES else "ffn", attr)


def _np_tensor(a, dtype: torch.dtype, what: str) -> torch.Tensor:
    """A numpy array (float32, or ``bfloat16`` as numpy holds JAX's bf16)
    as a CPU tensor of ``dtype``, bit for bit; another dtype raises."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if t.dtype != dtype:
        raise ValueError(f"{what} is {a.dtype}, the config wants {dtype}")
    return t


def _tensor_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def lm_from_jax(params_np: Dict, cfg: LMConfig,
                device: DeviceLike = None) -> LM:
    """The reference's LM params (``embed``, ``layers`` stacked along L,
    ``final_norm``, ``lm_head``, and an MoE config's unstacked
    ``dense_layers`` list; numpy arrays, each leaf in the port's dtype for
    it: ``cfg.dtype``, the router float32) -> an :class:`LM` on
    ``device``, each of ``layers`` one slice of the L axis, each of
    ``dense_layers`` one entry of the list."""
    model = LM(cfg, device)
    dense = params_np.get("dense_layers", [])
    if len(dense) != len(model.dense_layers):
        raise ValueError(f"{len(dense)} dense layers, the config "
                         f"{len(model.dense_layers)}")
    with torch.no_grad():
        for k in LM_TOP_KEYS:
            getattr(model, k).copy_(_np_tensor(params_np[k], cfg.dtype, k))
        for attr, p in (model.layers[0].named_parameters()
                        if len(model.layers) else ()):
            path = lm_leaf_path(attr)
            a = _at(params_np["layers"], path)
            if np.shape(a)[0] != len(model.layers):
                raise ValueError(f"layers.{'.'.join(path)} has "
                                 f"{np.shape(a)[0]} layers, the config "
                                 f"{len(model.layers)}")
            full = _np_tensor(a, p.dtype, ".".join(path))
            for i, blk in enumerate(model.layers):
                getattr(blk, attr).copy_(full[i])
        for i, blk in enumerate(model.dense_layers):
            for attr, p in blk.named_parameters():
                path = lm_leaf_path(attr)
                p.copy_(_np_tensor(_at(dense[i], path), p.dtype,
                                   f"dense_layers.{i}.{'.'.join(path)}"))
    return model


def _nest(leaves: Dict[str, np.ndarray]) -> Dict:
    """``{LMBlock leaf: array}`` -> one reference layer's nested dict."""
    out: Dict = {}
    for attr, a in leaves.items():
        path = lm_leaf_path(attr)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
    return out


def _lm_np(named: Dict[str, torch.Tensor]) -> Dict:
    """The reference's LM layout from ``{port name: tensor}``: the
    ``layers``' leaves stacked along L, the ``dense_layers`` a list."""
    out = {k: _tensor_np(named[k]) for k in LM_TOP_KEYS}
    groups: Dict[str, Dict[int, Dict[str, torch.Tensor]]] = {
        g: {} for g in LM_GROUPS}
    for key, t in named.items():
        parts = key.split(".")
        if parts[0] in groups:
            groups[parts[0]].setdefault(int(parts[1]), {})[parts[2]] = t
    layers = [groups["layers"][i] for i in range(len(groups["layers"]))]
    if layers:
        out["layers"] = _nest({attr: np.stack([_tensor_np(l[attr])
                                               for l in layers])
                               for attr in layers[0]})
    dense = groups["dense_layers"]
    if dense:
        out["dense_layers"] = [
            _nest({a: _tensor_np(t) for a, t in dense[i].items()})
            for i in range(len(dense))]
    return out


def lm_to_numpy(model: LM) -> Dict:
    """An :class:`LM` -> the reference's params layout, the layers stacked
    along L and the dense layers a list (the inverse of
    :func:`lm_from_jax`)."""
    return _lm_np(dict(model.named_parameters()))


def lm_grads_to_jax(grads: Dict[str, torch.Tensor]) -> Dict:
    """The port's ``{parameter name: gradient}`` (``lm_value_and_grad``)
    -> the reference's params layout, the layers' gradients stacked along
    L and the dense layers' a list, as ``jax.value_and_grad(lm_loss)``
    lays them out."""
    return _lm_np(grads)
