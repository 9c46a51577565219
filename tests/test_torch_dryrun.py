"""The port's dry run (``repro_torch.launch.dryrun``) and its pieces, on the
CPU over placeholder ranks (the ``fake`` backend):

- ``make_production_mesh``: the reference's shapes and dim names, its
  refusals, the placeholder group's, and the links it prices;
- the collective counter against the reference's ``parse_collective_bytes``
  on the sizes of its ``HLO_SAMPLE``, issued as DTensor redistributions and
  c10d calls;
- ``constrain``: the same object back on a plain tensor, the reference's
  divisibility rule on a ``DTensor``;
- every LM cell's placements at the production shapes against the
  reference's ``param_specs`` / ``batch_spec`` / ``kv_cache_specs`` (which
  read only a mesh's ``axis_names`` and ``devices.shape``), and the dry
  run's argument bytes against the shard bytes those specs give;
- the trace's FLOPs against ``FlopCounterMode`` on the real CPU run of the
  same step (``gcn-cora`` x ``full_graph_sm``, LM ``SMOKE`` cells);
- a ``SMOKE`` cell of each LM family and ``graphsage-reddit`` traced to
  ``ok`` on ``(2, 2)`` and ``(2, 2, 2)`` meshes;
- the command line: one cell on both production meshes, a skipped cell,
  and the report.

The module holds one placeholder group of 512 ranks; the command line runs
in processes of its own.
"""
import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro.launch.dryrun import parse_collective_bytes
from repro.models.lm import sharding as jsharding
from repro.models.lm import steps as jsteps
from repro.models.lm.transformer import init_kv_cache as j_init_kv_cache

from repro_torch import configs as tconfigs
from repro_torch.configs.base import LM_SHAPES, Built
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.models.lm import steps
from repro_torch.models.lm.sharding import DB, constrain
from repro_torch.models.lm.transformer import init_kv_cache, init_lm_params
from repro_torch.optim.adamw import adamw_init

LM_IDS = [n for n, a in tconfigs.REGISTRY.items() if a.family == "lm"]
CPU = torch.device("cpu")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def group():
    assert not dist.is_initialized()
    meshlib.init_placeholder_group(512)
    yield
    dist.destroy_process_group()


def test_production_mesh_shapes_names_and_refusals(group):
    m = meshlib.make_production_mesh(multi_pod=True, device_type="cpu")
    assert tuple(m.mesh.shape) == (2, 16, 16)
    assert m.mesh_dim_names == ("pod", "data", "model")
    assert m.mesh.flatten().tolist() == list(range(512))   # row-major
    with pytest.raises(RuntimeError, match="needs a process group of 256"):
        meshlib.make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="already initialised"):
        meshlib.init_placeholder_group(256)
    with pytest.raises(RuntimeError, match="at least 1024"):
        meshlib.make_mesh((32, 32), "cpu")
    # every production dim's groups cross nodes of 8: the NIC's rate
    assert {meshlib.link_bandwidth(m, d) for d in m.mesh_dim_names} == {
        meshlib.NIC_BW}
    small = meshlib.make_mesh((2, 2), "cpu")
    assert small.mesh_dim_names == ("data", "model")
    assert meshlib.link_bandwidth(small, "data") == meshlib.NVLINK_BW
    node = meshlib.make_mesh((4, 8), "cpu")
    assert meshlib.link_bandwidth(node, "model") == meshlib.NVLINK_BW
    assert meshlib.link_bandwidth(node, "data") == meshlib.NIC_BW


# the reference's HLO_SAMPLE (tests/test_dryrun_tools.py), op by op
HLO_SAMPLE = """
ENTRY %main {
  %ag = bf16[8,128,256]{2,1,0} all-gather(bf16[8,8,256]{2,1,0} %x), replica_groups={{0,1}}, dimensions={1}
  %ar = f32[1024,512]{1,0} all-reduce(f32[1024,512]{1,0} %y), to_apply=%add
  %rs = f32[64]{0} reduce-scatter(f32[512]{0} %z), dimensions={0}
  %cp.1 = bf16[32,32]{1,0} collective-permute-start(bf16[32,32]{1,0} %w), source_target_pairs={{0,1}}
  %a2a = (f32[16,16]{1,0}, f32[16,16]{1,0}) all-to-all(f32[16,16]{1,0} %p, f32[16,16]{1,0} %q)
}
"""


def test_collective_counter_against_the_reference_sample(group):
    """The sample's collectives, each moving its output's bytes: the
    all-gather and the all-reduce and reduce-scatter as DTensor
    redistributions, the permute and the all-to-all as c10d calls, on an
    (8, 64) mesh; per op, per count and in total (all-reduce x2) the
    reference's numbers, and per mesh dim."""
    mesh = meshlib.make_mesh((8, 64), "cpu")
    rep = (Replicate(), Replicate())

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    def fn(ag, ar, rs, cp, a2a):
        ag.redistribute(mesh, rep)                      # over model
        ar.redistribute(mesh, rep)                      # over data
        rs.redistribute(mesh, (Shard(0), Replicate()))  # over data
        data = mesh.get_group("data")
        dist.send(cp.to_local(), dst=dist.get_global_rank(data, 1),
                  group=data)
        x = a2a.to_local()
        dist.all_to_all_single(torch.empty_like(x), x, group=data)

    built = Built(
        fn,
        (meta((8, 128, 256), torch.bfloat16), meta((1024, 512), torch.float32),
         meta((512,), torch.float32), meta((32, 32), torch.bfloat16),
         meta((32, 16), torch.float32)),
        ((Replicate(), Shard(1)), (Partial(), Replicate()),
         (Partial(), Replicate()), rep, rep),
        dict(kind="test"), layout="global")
    rec = dryrun.trace_built(built, mesh, CPU)
    per_op, counts, total = parse_collective_bytes(HLO_SAMPLE)
    assert rec["collectives"] == per_op
    assert rec["collective_counts"] == counts
    assert rec["collective_bytes"] == total
    assert rec["collective_bytes_by_dim"] == {
        "model": per_op["all-gather"],
        "data": total - per_op["all-gather"]}
    # a model group is 64 consecutive ranks: 8 nodes, the NIC's rate too
    assert rec["roofline"]["t_collective"] == total / meshlib.NIC_BW


def test_constrain_is_the_identity_on_plain_tensors_and_the_rule_on_dtensors(
        group):
    x = torch.randn(8, 6, 4)
    assert constrain(x, DB, None, "model") is x
    mesh3 = meshlib.make_mesh((2, 2, 2), "cpu")
    mesh2 = meshlib.make_mesh((2, 2), "cpu")
    rep3 = (Replicate(),) * 3
    cases = [
        # mesh, global shape, names, placements wanted
        (mesh3, (8, 6, 4), (DB, None, "model"),
         (Shard(0), Shard(0), Shard(2))),
        # 6 is no multiple of pod x data = 4, 3 none of model = 2
        (mesh3, (6, 6, 3), (DB, None, "model"), rep3),
        # a dim smaller than the dims' size stays whole
        (mesh3, (2, 4, 4), (DB, "model"), (Replicate(), Replicate(),
                                           Shard(1))),
        # the mesh has no "pod": DB is "data" alone
        (mesh2, (6, 4), (DB, "model"), (Shard(0), Shard(1))),
        (mesh2, (4, 4), (None, None), (Replicate(), Replicate())),
    ]
    with FakeTensorMode():
        for mesh, shape, names, want in cases:
            loc = torch.empty(shape)
            d = DTensor.from_local(loc, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
            got = constrain(d, *names)
            assert tuple(got.placements) == want, (shape, names)
            assert constrain(got, *names) is got      # already pinned
        # a partial sum is reduced on the way
        p = DTensor.from_local(torch.empty(8, 4), mesh2,
                               (Partial(), Replicate()), run_check=False)
        assert tuple(constrain(p, DB, None).placements) == (Shard(0),
                                                            Replicate())


# ---------------------------------------------------------------------------
# the production shapes against the reference's specs
# ---------------------------------------------------------------------------

def _stand_in(mesh):
    """What the reference's rules read of a mesh."""
    return SimpleNamespace(axis_names=mesh.mesh_dim_names,
                           devices=SimpleNamespace(shape=tuple(
                               mesh.mesh.shape)))


def _placements(spec, names):
    out = []
    for a in names:
        dims = [i for i, s in enumerate(spec)
                if s == a or (isinstance(s, tuple) and a in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _jleaf(tree, name):
    """The reference's leaf for the port's parameter ``name``."""
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


def _shard_bytes(shape, itemsize, spec, sizes):
    n = itemsize
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    for dim, s in zip(shape, spec):
        axes = () if s is None else (s if isinstance(s, tuple) else (s,))
        n *= -(-dim // math.prod(sizes[a] for a in axes))
    return n


_REF_PARAMS = {}


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("name", LM_IDS)
def test_lm_placements_at_production_shapes_match_the_reference(
        group, name, multi):
    """Every cell of ``name`` on the production mesh: each parameter's
    placements are the reference's spec (a layer's with the stacked L
    dropped), the tokens' its ``batch_spec``, a decode cache's its
    ``kv_cache_specs``; the dry run's argument bytes (rank 0's shards) are
    the shard bytes the reference's specs give."""
    shape = (2, 16, 16) if multi else (16, 16)
    mesh = meshlib.make_mesh(shape, "cpu")
    names = mesh.mesh_dim_names
    jm = _stand_in(mesh)
    sizes = dict(zip(names, shape))
    arch = tconfigs.REGISTRY[name]
    cfg = arch.config
    jcfg = __import__(f"repro.configs.{name.replace('-', '_')}",
                      fromlist=["CONFIG"]).CONFIG
    if name not in _REF_PARAMS:
        _REF_PARAMS[name] = jsteps.abstract_params(jcfg)
    jp = _REF_PARAMS[name]
    jspec = jsharding.param_specs(jp, jm)
    for cell in LM_SHAPES:
        s = LM_SHAPES[cell]
        b = arch.build(cell, mesh)
        model, pshard = b.args[0], b.in_shardings[0]
        want = 0
        for pname, p in model.named_parameters():
            leaf, spec = _jleaf(jp, pname), tuple(_jleaf(jspec, pname))
            full = tuple(leaf.shape)
            if pname.startswith("layers."):
                full, spec = full[1:], spec[1:]
            assert tuple(p.shape) == full, pname
            assert pshard[pname] == _placements(spec, names), (pname, spec)
            n = _shard_bytes(full, p.element_size(), spec, sizes)
            # AdamW's m and v are float32 in the parameter's layout
            want += n * (1 + (8 // p.element_size() if s["kind"] == "train"
                              else 0))
        bspec = tuple(jsharding.batch_spec(s["batch"], jm))
        tok = b.in_shardings[1 if s["kind"] == "prefill" else 2]
        assert tok == _placements(bspec, names)
        if s["kind"] == "train":
            want += 4 + _shard_bytes((s["batch"], s["seq"]), 4, bspec, sizes)
        elif s["kind"] == "prefill":
            want += _shard_bytes((s["batch"], s["seq"]), 4, bspec, sizes)
        else:
            jc = jax_cache(jcfg, s["batch"], s["seq"])
            cspec = jsharding.kv_cache_specs(jc, jm, s["batch"])
            for k, t in b.args[1].items():
                sp = tuple(cspec["scan"][k])
                assert b.in_shardings[1][k] == _placements(sp, names), k
                want += _shard_bytes(tuple(t.shape), t.element_size(), sp,
                                     sizes)
            want += _shard_bytes((s["batch"], 1), 4, bspec, sizes) + 4
        assert dryrun.argument_bytes(b, mesh, CPU) == want, cell


def jax_cache(jcfg, batch, seq):
    import jax

    return jax.eval_shape(lambda: j_init_kv_cache(jcfg, batch, seq))


# ---------------------------------------------------------------------------
# the trace's counts against the real run's
# ---------------------------------------------------------------------------

def _smoke_built(name, kind, mesh, batch=2, seq=16):
    cfg = tconfigs.REGISTRY[name].smoke_config
    if kind == "train":
        fn = steps.make_train_step(cfg, device="cpu")[0]
        args, sh = steps.lm_train_inputs(cfg, batch, seq, mesh)
    elif kind == "prefill":
        fn = steps.make_prefill_step(cfg, device="cpu")
        args, sh = steps.lm_prefill_inputs(cfg, batch, seq, mesh)
    else:
        fn = steps.make_decode_step(cfg, device="cpu")
        args, sh = steps.lm_decode_inputs(cfg, batch, seq, mesh)
    return cfg, Built(fn, args, sh, dict(kind=kind), layout="global")


@pytest.mark.parametrize("name, kind", [
    ("phi3-medium-14b", "train"), ("mixtral-8x7b", "train"),
    ("deepseek-v2-236b", "decode")])
def test_trace_flops_equal_flop_counter_on_the_real_lm_step(group, name,
                                                            kind):
    """The dry run's FLOPs of a ``SMOKE`` step over a ``(1, 1)`` mesh (its
    arguments ``DTensor``\\s) are ``FlopCounterMode``'s on the real step
    with plain CPU tensors."""
    mesh = meshlib.make_mesh((1, 1), "cpu")
    cfg, b = _smoke_built(name, kind, mesh)
    rec = dryrun.trace_built(b, mesh, CPU)
    model = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    with FlopCounterMode(display=False) as fc:
        if kind == "train":
            b.fn(model, adamw_init(model), toks)
        else:
            b.fn(model, init_kv_cache(cfg, 2, 16, device="cpu"),
                 toks[:, :1], 16)
    assert rec["hlo_flops"] == fc.get_total_flops() > 0
    assert sum(rec["flops_by_dtype"].values()) == rec["hlo_flops"]


def test_trace_flops_equal_flop_counter_on_the_real_gnn_step(group):
    """``gcn-cora`` x ``full_graph_sm`` (the per-rank CAGNET step) on a
    ``(1, 1)`` mesh: the trace's FLOPs are ``FlopCounterMode``'s on the
    real step over zeroed CPU tensors of the same shapes."""
    mesh = meshlib.make_mesh((1, 1), "cpu")
    b = tconfigs.REGISTRY["gcn-cora"].build("full_graph_sm", mesh)
    assert b.layout == "per_rank"
    rec = dryrun.trace_built(b, mesh, CPU)
    real = [dryrun.materialize(a, s, mesh, CPU, b.layout)
            for a, s in zip(b.args, b.in_shardings)]
    for t in dryrun._local_tensors(real):
        t.data.zero_()
    with FlopCounterMode(display=False) as fc:
        b.fn(*real)
    assert rec["hlo_flops"] == fc.get_total_flops() > 0
    assert rec["memory"]["argument_bytes"] == sum(
        t.nbytes for t in dryrun._local_tensors(real))


def test_replayed_prefill_attention_counts_as_the_full_trace(group,
                                                             monkeypatch):
    """A ``SMOKE`` MLA prefill (every layer's attention through the plain
    ``chunked_attention``) with the repeated calls replayed records what
    the trace of every call records."""
    import contextlib

    mesh = meshlib.make_mesh((2, 2), "cpu")
    _, b = _smoke_built("deepseek-v2-236b", "prefill", mesh, batch=4,
                        seq=64)
    replayed = dryrun.trace_built(b, mesh, CPU)
    monkeypatch.setattr(dryrun, "_replayed_attention",
                        lambda trace: contextlib.nullcontext())
    full = dryrun.trace_built(b, mesh, CPU)
    assert replayed == full


@pytest.mark.parametrize("shape", [(2, 2), (2, 2, 2)],
                         ids=["2x2", "2x2x2"])
def test_a_smoke_cell_of_each_family_traces_ok(group, shape):
    """Phi-3 (dense GQA), Mixtral (MoE, sliding window) and DeepSeek-V2
    (MoE, MLA) at ``SMOKE``, and ``graphsage-reddit`` x ``full_graph_sm``,
    traced on a fake mesh: the record's memory adds up, and every count is
    positive."""
    mesh = meshlib.make_mesh(shape, "cpu")
    cells = ([("phi3-medium-14b", "train"), ("mixtral-8x7b", "train"),
              ("deepseek-v2-236b", "prefill")] if len(shape) == 2 else
             [("phi3-medium-14b", "decode"), ("mixtral-8x7b", "prefill"),
              ("deepseek-v2-236b", "train")])
    for name, kind in cells:
        _, b = _smoke_built(name, kind, mesh, batch=4)
        rec = dryrun.trace_built(b, mesh, CPU)
        assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0, name
        assert rec["collective_bytes"] > 0, name
        m = rec["memory"]
        assert m["argument_bytes"] > 0 and m["temp_bytes"] >= 0, name
        if kind == "train":      # parameters and AdamW state in place
            assert m["alias_bytes"] > 0.9 * m["argument_bytes"], name
    rec = dryrun.run_cell("graphsage-reddit", "full_graph_sm", False,
                          device="cpu", mesh=mesh)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "x".join(map(str, shape))
    assert rec["n_chips"] == math.prod(shape)
    assert rec["calibration"] is None
    assert set(rec["collective_bytes_by_dim"]) == {"data"}


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _cli(*argv, out):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
         "--out", str(out)], env=env, capture_output=True, text=True,
        timeout=300)


def test_command_line_on_both_production_meshes(tmp_path):
    r = _cli("--arch", "gcn-cora", "--shape", "full_graph_sm", "--mesh",
             "both", "--device", "cpu", out=tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("[")]
    assert [ln.split(" (")[0] for ln in lines] == [
        "[ok] gcn-cora full_graph_sm 16x16",
        "[ok] gcn-cora full_graph_sm 2x16x16"]
    for tag, n in (("16x16", 256), ("2x16x16", 512)):
        with open(tmp_path / f"gcn-cora__full_graph_sm__{tag}.json") as f:
            rec = json.load(f)
        assert (rec["mesh"], rec["n_chips"], rec["status"]) == (tag, n, "ok")
        # the reference's keys, and the port's
        for k in ("memory", "hlo_flops", "hlo_bytes", "collective_bytes",
                  "collectives", "collective_counts", "calibration",
                  "model_flops", "useful_flops_ratio", "roofline", "meta",
                  "flops_by_dtype", "collective_bytes_by_dim"):
            assert k in rec, k
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        assert rec["memory"]["code_bytes"] == 0
    r = _cli("--arch", "phi3-medium-14b", "--shape", "long_500k",
             "--device", "cpu", out=tmp_path)
    assert r.returncode == 0
    assert "[skipped] phi3-medium-14b long_500k 16x16" in r.stdout
    assert "sub-quadratic" in r.stdout
    r = _cli("--report", out=tmp_path)
    assert "=== dry-run report (3 cells) ===" in r.stdout


# ---------------------------------------------------------------------------
# what the dry run reads of the kernels and of the placement rules
# ---------------------------------------------------------------------------

def test_kernel_ops_trace_with_their_flop_formulas_and_sharding_rules(group):
    """The ``flash_attention`` and ``embedding_bag`` launches as operators:
    on fake tensors their fake implementations give the shapes (nothing is
    launched), ``FlopCounterMode`` reads their formulas (the attended
    pairs counted against a brute force), and on ``DTensor``s their
    sharding rules keep the batch (bags) split."""
    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops

    for Sq, Skv, causal, window in ((7, 7, True, -1), (5, 9, True, -1),
                                    (9, 5, True, -1), (8, 8, False, -1),
                                    (12, 12, True, 4), (6, 10, True, 3)):
        i, j = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
        seen = np.ones((Sq, Skv), bool)
        if causal:
            seen &= j <= i
        if window > 0:
            seen &= i - j < window
        assert flash_ops.attended_pairs(Sq, Skv, causal, window) == \
            int(seen.sum())
    launches = dict(flash_ops.LAUNCHES), dict(bag_ops.LAUNCHES)
    mesh = meshlib.make_mesh((2, 2), "cpu")
    with FakeTensorMode():
        q = torch.empty(4, 12, 8, 16)
        k = torch.empty(4, 12, 2, 16)
        with FlopCounterMode(display=False) as fc:
            out = torch.ops.repro_torch.flash_attention_fwd(q, k, k, True, 4)
        assert out.shape == q.shape
        assert fc.get_total_flops() == 4 * 8 * flash_ops.attended_pairs(
            12, 12, True, 4) * 4 * 16
        table = torch.empty(100, 32)
        ids = torch.empty(6, 5, dtype=torch.int32)
        with FlopCounterMode(display=False) as fc:
            bags = torch.ops.repro_torch.embedding_bag_fwd(table, ids, True)
        assert bags.shape == (6, 32)
        assert fc.get_total_flops() == 6 * 5 * 32
        batch = (Shard(0), Replicate())
        dq, dk = (DTensor.from_local(t[:2], mesh, batch, run_check=False)
                  for t in (q, k))
        o = torch.ops.repro_torch.flash_attention_fwd(dq, dk, dk, True, -1)
        assert tuple(o.placements) == batch and o.to_local().shape == (
            2, 12, 8, 16)
        dt = DTensor.from_local(table, mesh, (Replicate(), Replicate()),
                                run_check=False)
        di = DTensor.from_local(ids[:3], mesh, batch, run_check=False)
        b = torch.ops.repro_torch.embedding_bag_fwd(dt, di, False)
        assert tuple(b.placements) == batch and b.to_local().shape == (3, 32)
    assert (dict(flash_ops.LAUNCHES), dict(bag_ops.LAUNCHES)) == launches


def test_param_shardings_and_distribute_params(group):
    """``param_shardings`` is ``param_specs`` with its mesh (the
    reference's ``NamedSharding`` tree); ``distribute_params`` puts each
    parameter in those placements, ``requires_grad`` kept."""
    from repro_torch.models.lm.sharding import (
        distribute_params, param_shardings, param_specs,
    )

    mesh = meshlib.make_mesh((2, 2), "cpu")
    cfg = tconfigs.REGISTRY["deepseek-v2-236b"].smoke_config
    with FakeTensorMode():
        model = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
        specs = param_specs(model, mesh)
        sh = param_shardings(model, mesh)
        assert list(sh) == list(specs)
        assert all(m is mesh and pl == specs[k] for k, (m, pl) in sh.items())
        shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
        assert distribute_params(model, mesh) is model
        for k, p in model.named_parameters():
            assert isinstance(p, DTensor) and not p.requires_grad
            assert tuple(p.placements) == specs[k], k
            assert tuple(p.shape) == shapes[k], k
