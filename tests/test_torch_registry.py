"""The port's architecture registry (``repro_torch.configs``) against the
reference's (``repro.configs``).

- every port id: the same family, description, cells (kind and skip
  reason), runnable shapes and layer calibration as the reference's, and
  the reference's order;
- every LM cell (train, prefill, decode), every GNN cell in every build
  variant and every recsys cell: the port's ``Built`` against the
  reference's ``build`` on a ``(1, 1)`` ``("data", "model")`` mesh — the
  non-parameter arguments' shapes and dtypes, the placements against the
  reference's ``PartitionSpec``s (an LM layer's with the stacked L
  dropped, with the Megatron rules off and on), ``out_shardings`` and
  ``meta``;
- ``mfg_hop_sizes`` and ``gnn_model_flops`` on every GNN cell;
- every registered ``smoke(device="cpu")``: finite, ``grad_norm > 0``.

The port's builds take a ``DeviceMesh`` over a gloo process group of one
rank in this process.
"""
import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from repro import configs as jconfigs
from repro.configs import base as jbase

from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.launch.mesh import init_host_group, make_host_mesh

IDS = list(tconfigs.REGISTRY)
LM_IDS = [n for n in IDS if tconfigs.REGISTRY[n].family == "lm"]
GNN_IDS = [n for n in IDS if tconfigs.REGISTRY[n].family == "gnn"]
RECSYS_IDS = [n for n in IDS if tconfigs.REGISTRY[n].family == "recsys"]
VARIANTS = ("base", "unsharded", "halo")


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    init_host_group(str(tmp_path_factory.mktemp("pg") / "store"),
                    backend="gloo")
    yield make_host_mesh(1, 1), jax.make_mesh((1, 1), ("data", "model"))
    dist.destroy_process_group()


def test_registry_holds_the_ported_families_in_the_reference_order():
    assert IDS == ["mixtral-8x7b", "deepseek-v2-236b", "phi3-medium-14b",
                   "command-r-plus-104b", "deepseek-67b",
                   "graphsage-reddit", "pna", "graphcast", "gcn-cora",
                   "two-tower-retrieval", "gcn-igbm-3l"]
    assert IDS == list(jconfigs.REGISTRY)
    assert tconfigs.ASSIGNED == jconfigs.ASSIGNED
    want = [(a, s, (c.kind, c.skip)) for a, s, c in jconfigs.list_cells()]
    got = [(a, s, (c.kind, c.skip)) for a, s, c in tconfigs.list_cells()]
    assert got == want and len(got) == 40
    assert [(a, s, (c.kind, c.skip))
            for a, s, c in tconfigs.list_cells(assigned_only=False)] == [
        (a, s, (c.kind, c.skip))
        for a, s, c in jconfigs.list_cells(assigned_only=False)]
    assert len(tconfigs.list_cells(assigned_only=False)) == 44
    assert tconfigs.get_arch("pna") is tconfigs.REGISTRY["pna"]


@pytest.mark.parametrize("name", IDS)
def test_arch_spec_matches_reference(name):
    t, j = tconfigs.REGISTRY[name], jconfigs.REGISTRY[name]
    assert t.name == j.name == name
    assert t.family == j.family
    assert t.describe == j.describe
    assert {s: (c.kind, c.skip) for s, c in t.cells.items()} == \
        {s: (c.kind, c.skip) for s, c in j.cells.items()}
    assert list(t.cells) == list(j.cells)
    assert t.runnable_shapes() == j.runnable_shapes()
    assert t.layer_calib == j.layer_calib
    if t.family == "gnn":
        # the family comes from the GNNArch, not from the id
        assert dataclasses.asdict(t.config) == dataclasses.asdict(
            _reference_config(name))
    if t.family == "lm":
        mod = importlib.import_module(
            f"repro.configs.{name.replace('-', '_')}")
        for tc, jc in ((t.config, mod.CONFIG), (t.smoke_config, mod.SMOKE)):
            assert [f.name for f in dataclasses.fields(tc)] == \
                [f.name for f in dataclasses.fields(jc)]
            for f in dataclasses.fields(tc):
                a, b = getattr(tc, f.name), getattr(jc, f.name)
                if f.name == "moe" and a is not None:
                    # two packages' MoEConfig classes: field by field
                    a, b = dataclasses.asdict(a), dataclasses.asdict(b)
                if f.name != "dtype":
                    assert a == b, f.name
            assert str(tc.dtype).split(".")[-1] == np.dtype(jc.dtype).name
            assert tc.param_count() == jc.param_count()


def _reference_config(name):
    for m in jconfigs._MODULES:
        mod = importlib.import_module(f"repro.configs.{m}")
        if mod.ARCH.name == name:
            return getattr(mod, "CONFIG_3L", None) or mod.CONFIG
    raise KeyError(name)


def test_gcn_igbm_constants_match_reference():
    from repro.configs import gcn_igbm as j
    from repro_torch.configs import gcn_igbm as t

    for k in ("IGBM", "PRODUCTS", "PAPERS"):
        assert getattr(t, k) == getattr(j, k)
    assert dataclasses.asdict(t.CONFIG_5L) == dataclasses.asdict(j.CONFIG_5L)
    # the products constants are the ogb_products cell's
    s = tbase.GNN_SHAPES["ogb_products"]
    assert {k: s[k] for k in t.PRODUCTS} == t.PRODUCTS


def test_shapes_match_reference():
    assert tbase.GNN_SHAPES == jbase.GNN_SHAPES
    assert tbase.LM_SHAPES == jbase.LM_SHAPES
    assert tbase.RECSYS_SHAPES == jbase.RECSYS_SHAPES


@pytest.mark.parametrize("name", GNN_IDS)
def test_hop_sizes_and_flops_match_reference(name):
    from repro_torch.configs.builders import _gnn_dims

    a = tconfigs.REGISTRY[name].config
    for shape, s in tbase.GNN_SHAPES.items():
        dims = _gnn_dims(a, s["d_feat"], s["classes"])
        for train in (True, False):
            assert tbase.gnn_model_flops(
                dims, s["n_nodes"], s["n_edges"], train, a.model) == \
                jbase.gnn_model_flops(
                    dims, s["n_nodes"], s["n_edges"], train, a.model)
        if s["kind"] == "mfg":
            for groups in (1, 4, 16):
                assert tbase.mfg_hop_sizes(
                    a.n_layers, s["batch_nodes"], s["fanout"], s["n_nodes"],
                    groups) == jbase.mfg_hop_sizes(
                    a.n_layers, s["batch_nodes"], s["fanout"], s["n_nodes"],
                    groups)


def _flat(x):
    """Leaves of nested tuples; a tuple of placements is one leaf."""
    if isinstance(x, (tuple, list)) and not all(
            isinstance(p, (Shard, Replicate)) for p in x):
        return [leaf for v in x for leaf in _flat(v)]
    return [x]


def _placements(spec, names=("data", "model")):
    """A reference ``PartitionSpec`` as placements over the mesh dims."""
    out = []
    for a in names:
        dims = [i for i, s in enumerate(spec)
                if s == a or (isinstance(s, tuple) and a in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(jax.numpy.bfloat16): torch.bfloat16}


def _same_args(targs, tshard, jargs, jshard):
    """Non-parameter arguments: shapes, dtypes (the port's dtype is the
    reference's, float32 and int32 throughout) and placements."""
    ta, ja = _flat(targs), jax.tree.leaves(jargs)
    ts = _flat(tshard)
    js = jax.tree.leaves(jshard, is_leaf=lambda s: hasattr(s, "spec"))
    assert len(ta) == len(ja) == len(ts) == len(js)
    for t, j, pt, pj in zip(ta, ja, ts, js):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(j.shape)
        assert t.dtype == _DTYPES[np.dtype(j.dtype)]
        assert pt == _placements(pj.spec)


def _lm_leaf(tree, name):
    """The reference's LM leaf for the port's parameter ``name``:
    ``layers.<i>.wq`` is the stacked ``["layers"]["attn"]["wq"]``,
    ``dense_layers.<i>.w_gate`` the unstacked
    ``["dense_layers"][i]["ffn"]["w_gate"]``, ``embed`` ``["embed"]``."""
    from repro_torch.params import lm_leaf_path

    parts = name.split(".")
    if parts[0] == "layers":
        leaf = tree["layers"]
    elif parts[0] == "dense_layers":
        leaf = tree["dense_layers"][int(parts[1])]
    else:
        return tree[name]
    for key in lm_leaf_path(parts[2]):
        leaf = leaf[key]
    return leaf


def _same_lm_params(model, pshard, jparams, jspecs):
    """The port's parameters and their placements against the reference's
    leaves and specs (every reference leaf matched once): a layer's shape
    and spec are the stacked leaf's without L; a dense layer's are its
    own."""
    names = [n for n, _ in model.named_parameters()]
    assert list(pshard) == names
    n_ref = len(jax.tree.leaves(jparams))
    assert n_ref == len([n for n in names if not n.startswith("layers.")]) \
        + len({n.split(".", 2)[2] for n in names if n.startswith("layers.")})
    for name, p in model.named_parameters():
        jp, js = _lm_leaf(jparams, name), _lm_leaf(jspecs, name)
        shape, spec = tuple(jp.shape), tuple(js.spec)
        if name.startswith("layers."):
            assert shape[0] == len(model.layers)
            shape, spec = shape[1:], spec[1:]
        assert p.is_meta and tuple(p.shape) == shape, name
        assert p.dtype == _DTYPES[np.dtype(jp.dtype)], name
        assert pshard[name] == _placements(spec), (name, spec)


@pytest.mark.parametrize("megatron", ["0", "1"])
@pytest.mark.parametrize("shape", list(tbase.LM_SHAPES))
@pytest.mark.parametrize("name", LM_IDS)
def test_lm_build_matches_reference(meshes, monkeypatch, name, shape,
                                    megatron):
    """Train, prefill and decode builds: ``meta``, the non-parameter
    arguments, the parameters' (and AdamW state's) shapes and placements
    against the reference's specs with L dropped, ``out_shardings``; the
    Megatron rules off and on (``REPRO_MEGATRON``, read by both)."""
    tmesh, jmesh = meshes
    monkeypatch.setenv("REPRO_MEGATRON", megatron)
    tb = tconfigs.REGISTRY[name].build(shape, tmesh)
    jb = jconfigs.REGISTRY[name].build(shape, jmesh)
    assert tb.meta == jb.meta
    assert callable(tb.fn)
    _same_lm_params(tb.args[0], tb.in_shardings[0], jb.args[0],
                    jb.in_shardings[0])
    kind = jb.meta["kind"]
    if kind == "train":
        topt, jopt = tb.args[1], jb.args[1]
        tm = topt["m"]
        for k, t in tm.items():
            j = _lm_leaf(jopt["m"], k)
            want = tuple(j.shape)[1:] if k.startswith("layers.") \
                else tuple(j.shape)
            assert t.is_meta and t.dtype == torch.float32 and \
                tuple(t.shape) == want
        assert tuple(topt["step"].shape) == () and \
            topt["step"].dtype == torch.int32
        assert tb.in_shardings[1] == {"m": tb.in_shardings[0],
                                      "v": tb.in_shardings[0],
                                      "step": (Replicate(), Replicate())}
        _same_args(tb.args[2:], tb.in_shardings[2:], jb.args[2:],
                   jb.in_shardings[2:])
        assert tb.out_shardings == (tb.in_shardings[0], tb.in_shardings[1],
                                    None)
    elif kind == "prefill":
        _same_args(tb.args[1:], tb.in_shardings[1:], jb.args[1:],
                   jb.in_shardings[1:])
        assert tb.out_shardings is None and jb.out_shardings is None
    else:
        # the port's one (n_layers, ...) cache a name, in LM.blocks()
        # order, against the reference's {"scan": {name}, "dense": {name}
        # or None}: the same names, the layers summed, each part placed
        # as the port's whole
        cache, jcache = tb.args[1], jb.args[1]
        parts = [g for g in ("dense", "scan") if jcache[g] is not None]
        assert list(cache) == list(jcache["scan"])
        for k, t in cache.items():
            js = [jcache[g][k] for g in parts]
            assert t.device.type == "meta"
            assert t.shape[0] == sum(j.shape[0] for j in js)
            for g, j in zip(parts, js):
                assert tuple(t.shape[1:]) == tuple(j.shape[1:])
                assert t.dtype == _DTYPES[np.dtype(j.dtype)]
                assert tb.in_shardings[1][k] == _placements(
                    jb.in_shardings[1][g][k].spec)
        _same_args(tb.args[2:], tb.in_shardings[2:], jb.args[2:],
                   jb.in_shardings[2:])
        assert tb.out_shardings == (None, tb.in_shardings[1])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", list(tbase.GNN_SHAPES))
@pytest.mark.parametrize("name", GNN_IDS)
def test_gnn_build_matches_reference(meshes, name, shape, variant):
    tmesh, jmesh = meshes
    tb = tconfigs.REGISTRY[name].build(shape, tmesh, variant=variant)
    jb = jconfigs.REGISTRY[name].build(shape, jmesh, variant=variant)
    assert tb.meta == jb.meta
    assert callable(tb.fn)
    _same_args(tb.args[2:], tb.in_shardings[2:], jb.args[2:],
               jb.in_shardings[2:])
    # parameters and AdamW state: replicated, the reference's leaf count
    # and sizes (the port's dense weights are the transpose)
    rep = (Replicate(), Replicate())
    assert tb.in_shardings[0] == rep
    assert tb.in_shardings[1] == {"m": rep, "v": rep, "step": rep}
    assert all(s.spec == jax.sharding.PartitionSpec() for s in
               jax.tree.leaves(jb.in_shardings[0],
                               is_leaf=lambda s: hasattr(s, "spec")))
    tp = list(tb.args[0].parameters())
    jp = jax.tree.leaves(jb.args[0])
    assert all(p.is_meta for p in tp)
    assert sorted(p.numel() for p in tp) == sorted(int(np.prod(p.shape))
                                                   for p in jp)
    assert sorted(t.numel() for t in tb.args[1]["m"].values()) == \
        sorted(int(np.prod(p.shape)) for p in jax.tree.leaves(jb.args[1]["m"]))


def _recsys_param_paths(tree):
    """The reference's two-tower param paths as the port's names
    (``user_mlp.0.w`` for ``["user_mlp"][0]["w"]``)."""
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda s: hasattr(s, "spec")):
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out[".".join(keys)] = leaf
    return out


@pytest.mark.parametrize("shape", list(tbase.RECSYS_SHAPES))
@pytest.mark.parametrize("name", RECSYS_IDS)
def test_recsys_build_matches_reference(meshes, name, shape):
    tmesh, jmesh = meshes
    tb = tconfigs.REGISTRY[name].build(shape, tmesh)
    jb = jconfigs.REGISTRY[name].build(shape, jmesh)
    assert tb.meta == jb.meta
    n_state = 2 if jb.meta["kind"] == "train" else 1
    _same_args(tb.args[n_state:], tb.in_shardings[n_state:],
               jb.args[n_state:], jb.in_shardings[n_state:])
    # parameters: the same names, shapes, dtypes and placements
    tparams = dict(tb.args[0].state_dict(keep_vars=True))
    jparams = _recsys_param_paths(jb.args[0])
    jspecs = _recsys_param_paths(jb.in_shardings[0])
    assert tparams.keys() == jparams.keys() == tb.in_shardings[0].keys()
    for k, t in tparams.items():
        assert t.is_meta and tuple(t.shape) == tuple(jparams[k].shape)
        assert tb.in_shardings[0][k] == _placements(jspecs[k].spec), k


@pytest.mark.parametrize("name", IDS)
def test_smoke_on_cpu_is_finite(name):
    r = tconfigs.REGISTRY[name].smoke(device="cpu")
    assert r["finite"] and r["grad_norm"] > 0 and np.isfinite(r["loss"])
