"""The port's distributed GNN steps and split-KV decoding
(``repro_torch.distributed``) against the reference's.

On ``kronecker_graph(512, 6)`` plus self loops with seeded numpy inputs and
the reference's weights (converted with ``params_from_jax``):

- the CAGNET full-graph step against the reference's
  ``make_fullgraph_train_step`` (jitted, one device) for all six families;
- the sampled-MFG and batched-graph steps against the reference's;
- in one subprocess of 4 gloo ranks that imports only ``repro_torch``
  (inputs and results through ``.npz`` files): the partitioned-halo step
  against the reference's ``full_graph_loss`` and its ``m`` against the
  reference's CAGNET step, the CAGNET step (sharded and unsharded) at
  world 4 against world 1, and split-KV decoding against the reference's
  ``decode_attention_ref``.

The port's steps run in a gloo group of one rank in this process.
Tolerances: losses within 1e-4 relative and AdamW's first moment ``m``
(``(1 - b1) * grad``) within 1e-4 max-relative a leaf; the updated
parameters are not compared (AdamW's first step moves a weight by ±lr
where its gradient is near 0, so a float32 sign flip between the two
frameworks moves it by 2 lr).
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.distributed import gnn_parallel as jgp
from repro.graph import gcn_norm_coeffs, kronecker_graph
from repro.graph.csr import add_self_loops
from repro.graph.synthetic import random_features, random_labels
from repro.models.gnn.layers import get_gnn as jget_gnn
from repro.optim.adamw import adamw_init as jadamw_init

from repro_torch.distributed import gnn_parallel as tgp
from repro_torch.launch.mesh import init_host_group
from repro_torch.optim import adamw_init
from repro_torch.params import grads_to_jax, params_from_jax

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = [("gcn", "ce"), ("sage", "ce"), ("gat", "ce"), ("gin", "ce"),
            ("pna", "ce"), ("graphcast", "mse")]
LOSS_TOL = 1e-4
M_TOL = 1e-4
D_FEAT, D_HIDDEN, D_OUT = 16, 24, 8


@pytest.fixture(scope="module", autouse=True)
def group(tmp_path_factory):
    """A gloo process group of one rank for the port's steps."""
    init_host_group(str(tmp_path_factory.mktemp("pg") / "store"),
                    backend="gloo")
    yield
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def graph():
    return add_self_loops(kronecker_graph(512, 6, seed=0))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def _m_np(m, model: str):
    """The port's ``opt_state["m"]`` (a flat ``state_dict``-keyed dict of a
    ``ModuleList``) -> the reference's per-layer numpy layout."""
    n = 1 + max(int(k.split(".", 1)[0]) for k in m)
    layers = [{k.split(".", 1)[1]: v for k, v in m.items()
               if k.split(".", 1)[0] == str(i)} for i in range(n)]
    return grads_to_jax(layers, model)


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _check(tloss, tstate, jloss, jstate, model: str):
    assert _rel(float(tloss), float(jloss)) <= LOSS_TOL, (tloss, jloss)
    got = jax.tree.leaves(_m_np(tstate["m"], model))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jstate["m"]))
    assert len(got) == len(want)
    errs = [_max_rel(g, w) for g, w in zip(got, want)]
    assert max(errs) <= M_TOL, errs
    assert int(tstate["step"]) == int(jstate["step"]) == 1


def _jparams(model: str, d_in=D_FEAT, d_out=D_OUT):
    return jget_gnn(model).init(jax.random.PRNGKey(0), d_in, D_HIDDEN,
                                d_out, 2)


def _tparams(jp, model: str):
    return params_from_jax(jax.tree.map(np.asarray, jp), "cpu", model)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def fullgraph_arrays(g, loss_kind: str, d_out: int = D_OUT):
    """The full-graph step's inputs, as ``tests/test_distributed.py``
    builds them (one rank: no padding)."""
    src, dst = g.edge_index()
    ew = gcn_norm_coeffs(g).astype(np.float32)
    x = random_features(g.n_nodes, D_FEAT, 0)
    deg = np.maximum(g.in_degrees(), 1).astype(np.float32)
    if loss_kind == "mse":
        y = random_features(g.n_nodes, d_out, 1)
    else:
        y = random_labels(g.n_nodes, d_out, 0)
    return x, src.astype(np.int32), dst.astype(np.int32), ew, deg, y


# ------------------------------------------------------------------ CAGNET

@pytest.mark.parametrize("model,loss_kind", FAMILIES)
def test_fullgraph_step_matches_reference(graph, model, loss_kind):
    n = graph.n_nodes
    args = fullgraph_arrays(graph, loss_kind)
    jp = _jparams(model)
    jstep = jax.jit(jgp.make_fullgraph_train_step(model, n,
                                                  loss_kind=loss_kind))
    _, jo, jloss = jstep(jp, jadamw_init(jp), *args)
    tp = _tparams(jp, model)
    for sharded, remat in ((True, True), (False, False)):
        step = tgp.make_fullgraph_train_step(model, n, loss_kind=loss_kind,
                                             sharded=sharded, remat=remat)
        tp2, to, tloss = step(tp, adamw_init(tp), *_t(*args))
        _check(tloss, to, jloss, jo, model)
    # functional: the inputs are unchanged, the update moved the weights
    assert all(torch.equal(a, b) for a, b in
               zip(tp.parameters(), _tparams(jp, model).parameters()))
    assert any(not torch.equal(a, b) for a, b in
               zip(tp.parameters(), tp2.parameters()))


def test_gat_score_kink_at_zero_matches_reference():
    """A GAT score is exactly 0 where both endpoint rows are zero (rows
    with no incoming edge after an ELU, as sampled MFGs have): the
    gradient of ``leaky_relu`` there is 1 in the reference, and the port's
    layer must take the same branch."""
    from repro.models.gnn.layers import LocalTopo as JTopo
    from repro_torch.models.gnn.layers import LocalTopo as TTopo
    from repro_torch.models.gnn.layers import get_gnn as tget_gnn

    rng = np.random.default_rng(5)
    n, E = 48, 200
    src = rng.integers(0, n, E).astype(np.int32)
    dst = rng.integers(0, n, E).astype(np.int32)
    mask = np.ones(E, np.float32)
    deg = np.maximum(np.bincount(dst, minlength=n), 1).astype(np.float32)
    h0 = rng.standard_normal((n, D_HIDDEN)).astype(np.float32)
    h0[::3] = 0.0
    jp = _jparams("gat")
    jtopo = JTopo(src=jnp.asarray(src), dst=jnp.asarray(dst), n_dst=n,
                  edge_weight=jnp.asarray(mask), edge_mask=jnp.asarray(mask),
                  in_deg=jnp.asarray(deg),
                  dst_self=jnp.arange(n, dtype=jnp.int32))
    want = np.asarray(jax.jit(jax.grad(lambda h: jnp.sum(
        jget_gnn("gat").apply_layer(jp[1], h, jtopo, activate=False) ** 2
    )))(jnp.asarray(h0)))
    s, d, m, dg = _t(src, dst, mask, deg)
    ttopo = TTopo(src=s, dst=d, n_dst=n, edge_weight=m, edge_mask=m,
                  in_deg=dg, dst_self=torch.arange(n, dtype=torch.int32),
                  n_real_edges=E)
    h = torch.from_numpy(h0).requires_grad_(True)
    (tget_gnn("gat").apply_layer(_tparams(jp, "gat")[1], h, ttopo,
                                 activate=False) ** 2).sum().backward()
    assert _max_rel(h.grad.numpy(), want) <= 1e-5


# ------------------------------------------------------- MFG and batched

def random_edges(rng, G: int, n_src: int, n_dst: int, n_e: int):
    """``G`` random edge sets: sources in ``[0, n_src)``; the first
    ``n_dst`` edges one real edge into each destination (an MFG's seeds
    and a molecule's atoms all have neighbours: PNA's min and max of an
    empty neighbourhood are -+1e30, which overflow to NaN in both
    packages), the rest into random destinations with a tenth of them
    masked out; each destination's degree its count of real edges."""
    src = rng.integers(0, n_src, (G, n_e)).astype(np.int32)
    dst = rng.integers(0, n_dst, (G, n_e)).astype(np.int32)
    dst[:, :n_dst] = np.arange(n_dst)
    mask = (rng.random((G, n_e)) > 0.1).astype(np.float32)
    mask[:, :n_dst] = 1.0
    deg = np.stack([np.bincount(d, weights=m, minlength=n_dst)
                    for d, m in zip(dst, mask)]).astype(np.float32)
    return src, dst, mask, deg


def mfg_arrays(hops, G: int, loss_kind: str, seed: int = 0):
    """Random MFG hops of the given sizes (:func:`random_edges`)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, hops[0][0], D_FEAT)).astype(np.float32)
    flat = [random_edges(rng, G, n_src, n_dst, n_e)
            for n_src, n_dst, n_e in hops]
    n_seed = hops[-1][1]
    if loss_kind == "mse":
        y = rng.standard_normal((G, n_seed, D_OUT)).astype(np.float32)
    else:
        y = rng.integers(0, D_OUT, (G, n_seed)).astype(np.int32)
    return x, flat, y


@pytest.mark.parametrize("model,loss_kind", FAMILIES)
def test_mfg_step_matches_reference(model, loss_kind):
    from repro.configs.base import mfg_hop_sizes

    G = 2
    hops = mfg_hop_sizes(2, 64, (5, 3), 512, G)
    x, flat, y = mfg_arrays(hops, G, loss_kind)
    jp = _jparams(model)
    jstep = jax.jit(jgp.make_mfg_train_step(model, hops, loss_kind=loss_kind))
    _, jo, jloss = jstep(jp, jadamw_init(jp), x,
                         tuple(tuple(h) for h in flat), y)
    tp = _tparams(jp, model)
    step = tgp.make_mfg_train_step(model, hops, loss_kind=loss_kind)
    _, to, tloss = step(tp, adamw_init(tp), torch.from_numpy(x),
                        tuple(tuple(_t(*h)) for h in flat),
                        torch.from_numpy(y))
    _check(tloss, to, jloss, jo, model)


@pytest.mark.parametrize("model,loss_kind", FAMILIES)
def test_batched_graph_step_matches_reference(model, loss_kind):
    B, n, E = 4, 30, 64
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, n, D_FEAT)).astype(np.float32)
    src, dst, mask, deg = random_edges(rng, B, n, n, E)
    y = (rng.standard_normal((B, D_OUT)).astype(np.float32)
         if loss_kind == "mse" else
         rng.integers(0, D_OUT, B).astype(np.int32))
    args = (x, src, dst, mask, deg, y)
    jp = _jparams(model)
    jstep = jax.jit(jgp.make_batched_graph_train_step(model, n,
                                                      loss_kind=loss_kind))
    _, jo, jloss = jstep(jp, jadamw_init(jp), *args)
    tp = _tparams(jp, model)
    step = tgp.make_batched_graph_train_step(model, n, loss_kind=loss_kind)
    _, to, tloss = step(tp, adamw_init(tp), *_t(*args))
    _check(tloss, to, jloss, jo, model)


def test_build_partitioned_data_matches_reference(graph):
    parts = (np.arange(graph.n_nodes) % 4).astype(np.int32)
    ew = gcn_norm_coeffs(graph)
    jdata, jn, jh, jro = jgp.build_partitioned_data(graph, parts, 4, ew)
    tdata, tn, th, tro = tgp.build_partitioned_data(graph, parts, 4, ew)
    assert (jn, jh) == (tn, th)
    assert np.array_equal(jro.perm, tro.perm)
    for k in jdata:
        assert jdata[k].dtype == tdata[k].dtype
        assert np.array_equal(jdata[k], tdata[k]), k


def test_fullgraph_shards_cover_every_edge_once():
    rng = np.random.default_rng(0)
    n_pad, world = 40, 4
    dst = np.sort(rng.integers(0, n_pad, 300)).astype(np.int32)
    src = rng.integers(0, n_pad, 300).astype(np.int32)
    ew = rng.random(300).astype(np.float32) + 0.5
    shards = tgp.fullgraph_shards(n_pad, src, dst, ew, world)
    assert len({s[0].shape for s in shards}) == 1
    got = []
    for r, (s, d, w) in enumerate(shards):
        real = w != 0
        assert np.all(d // (n_pad // world) == r)     # padding included
        got += list(zip(s[real], d[real], w[real]))
    assert sorted(got) == sorted(zip(src, dst, ew))


# ---------------------------------------------------------- 4 gloo ranks

WORKER = textwrap.dedent('''
    """4 gloo ranks: halo step, CAGNET at world 4, split-KV decode."""
    import os
    import sys

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def rank_main(rank, world, store, inp, out):
        from repro_torch.distributed import collectives as tc
        from repro_torch.distributed import gnn_parallel as tgp
        from repro_torch.graph.csr import CSRGraph
        from repro_torch.launch.mesh import init_host_group, make_host_mesh
        from repro_torch.models.gnn.layers import GCNLayer
        from repro_torch.optim import adamw_init
        from repro_torch.params import params_from_jax

        torch.set_num_threads(1)
        init_host_group(store, rank, world, backend="gloo")
        d = dict(np.load(inp))
        res = {}

        def params():
            return params_from_jax(
                [{"lin": {"w": d["w0"], "b": d["b0"]}},
                 {"lin": {"w": d["w1"], "b": d["b1"]}}], "cpu", "gcn")

        def put(name, state, loss):
            res[name + "_loss"] = np.float32(loss)
            for k, v in state["m"].items():
                res[f"{name}_m/{k}"] = v.numpy()

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a))

        # the partitioned-halo step, one partition a rank
        g = CSRGraph(indptr=d["indptr"], indices=d["indices"],
                     n_nodes=int(d["n"]))
        parts = (np.arange(g.n_nodes) % world).astype(np.int32)
        data, n_local, n_halo, ro = tgp.build_partitioned_data(
            g, parts, world, d["ew"])
        mesh = make_host_mesh(world, 1)
        step = tgp.make_partitioned_train_step("gcn", n_local, n_halo, mesh)
        p = params()
        rows = slice(rank * n_local, (rank + 1) * n_local)
        _, o, loss = step(
            p, adamw_init(p), t(d["x"][ro.perm][rows]),
            *[t(data[k][rank]) for k in ("lsrc", "ldst", "lew", "hsrc",
                                         "hdst", "hew", "halo", "deg")],
            t(d["y"][ro.perm][rows]))
        put("halo", o, loss)
        res["halo_perm"] = ro.perm

        # the CAGNET step at world 4, rows split in rank order
        n = int(d["n"])
        shards = tgp.fullgraph_shards(n, d["src"], d["dst"], d["gcn_ew"],
                                      world)
        s, dd, w = (t(a) for a in shards[rank])
        nl = n // world
        rows = slice(rank * nl, (rank + 1) * nl)
        for sharded in (True, False):
            p = params()
            step = tgp.make_fullgraph_train_step("gcn", n, sharded=sharded)
            _, o, loss = step(p, adamw_init(p), t(d["x"][rows]), s, dd, w,
                              t(d["deg"][rows]), t(d["y"][rows]))
            put(f"cagnet{int(sharded)}", o, loss)

        # split-KV decode over the model dim of a (1, 4) mesh and over
        # both dims of a (2, 2) mesh
        for shape, axes in (((1, 4), ("model",)),
                            ((2, 2), ("data", "model"))):
            m = make_host_mesh(*shape)
            S = d["k"].shape[1] // world
            idx = 0
            for a in axes:
                idx = (idx * m.size(m.mesh_dim_names.index(a))
                       + m.get_local_rank(a))
            kv = slice(idx * S, (idx + 1) * S)
            for win in (None, 16):
                fn = tc.make_split_kv_decode(m, axes, window=win)
                o = fn(t(d["q"]), t(d["k"][:, kv]), t(d["v"][:, kv]),
                       int(d["cache_len"]))
                res[f"kv_{shape[0]}x{shape[1]}_{win}"] = o.numpy()
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "repro"))
        assert not bad, bad
        if rank == 0:
            np.savez(out, **res)
        dist.barrier()
        dist.destroy_process_group()


    if __name__ == "__main__":
        store, inp, out = sys.argv[1:]
        mp.spawn(rank_main, args=(4, store, inp, out), nprocs=4)
''')


@pytest.fixture(scope="module")
def four_ranks(graph, tmp_path_factory):
    """Run the 4-rank worker once; returns its inputs and its results."""
    tmp = tmp_path_factory.mktemp("four_ranks")
    g = graph
    n = g.n_nodes
    x = random_features(n, D_FEAT, 0)
    y = random_labels(n, D_OUT, 0)
    src, dst = g.edge_index()
    jp = _jparams("gcn")
    rng = np.random.default_rng(0)
    B, S, Hq, Hkv, D = 2, 64, 8, 2, 16
    inp = dict(
        n=n, indptr=g.indptr, indices=g.indices, ew=gcn_norm_coeffs(g),
        gcn_ew=gcn_norm_coeffs(g).astype(np.float32),
        src=src.astype(np.int32), dst=dst.astype(np.int32), x=x, y=y,
        deg=np.maximum(g.in_degrees(), 1).astype(np.float32),
        w0=np.asarray(jp[0]["lin"]["w"]), b0=np.asarray(jp[0]["lin"]["b"]),
        w1=np.asarray(jp[1]["lin"]["w"]), b1=np.asarray(jp[1]["lin"]["b"]),
        q=rng.standard_normal((B, 1, Hq, D)).astype(np.float32),
        k=rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
        v=rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
        cache_len=50,
    )
    np.savez(tmp / "in.npz", **inp)
    (tmp / "worker.py").write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(tmp / "worker.py"), str(tmp / "store"),
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return inp, jp, dict(np.load(tmp / "out.npz"))


def _m_of(res, name):
    pre = name + "_m/"
    return {k[len(pre):]: torch.from_numpy(v) for k, v in res.items()
            if k.startswith(pre)}


def test_four_rank_halo_step_matches_the_oracle(four_ranks):
    from repro.core.plan import build_plan
    from repro.models.gnn.layers import full_graph_loss, full_graph_topo

    inp, jp, res = four_ranks
    g = add_self_loops(kronecker_graph(512, 6, seed=0))
    n = g.n_nodes
    perm = res["halo_perm"]
    parts = (np.arange(n) % 4).astype(np.int32)
    plan = build_plan(g, parts, 4, edge_weight=gcn_norm_coeffs(g))
    assert np.array_equal(plan.ro.perm, perm)
    rg = plan.ro.graph
    topo = full_graph_topo(rg.indptr, rg.indices, n,
                           np.asarray(plan.edge_weight))
    xr, yr = inp["x"][perm], inp["y"][perm]
    oracle = full_graph_loss(jget_gnn("gcn"), jp, jnp.asarray(xr), topo,
                             jnp.asarray(yr))
    assert abs(float(res["halo_loss"]) - float(oracle)) < 1e-5
    # its gradient is the reference CAGNET step's on the reordered graph
    src, dst = rg.edge_index()
    deg = np.maximum(rg.in_degrees(), 1).astype(np.float32)
    step = jax.jit(jgp.make_fullgraph_train_step("gcn", n))
    _, jo, jloss = step(jp, jadamw_init(jp), xr, src, dst,
                        np.asarray(plan.edge_weight, np.float32), deg, yr)
    _check(res["halo_loss"], dict(m=_m_of(res, "halo"), step=1), jloss, jo,
           "gcn")


def test_four_rank_cagnet_step_matches_one_rank(four_ranks):
    inp, jp, res = four_ranks
    tp = _tparams(jp, "gcn")
    step = tgp.make_fullgraph_train_step("gcn", int(inp["n"]))
    _, o1, loss1 = step(tp, adamw_init(tp), *_t(
        inp["x"], inp["src"], inp["dst"], inp["gcn_ew"], inp["deg"],
        inp["y"]))
    for name in ("cagnet1", "cagnet0"):
        assert _rel(float(res[name + "_loss"]), float(loss1)) <= LOSS_TOL
        m4 = _m_of(res, name)
        assert m4.keys() == o1["m"].keys()
        errs = [_max_rel(m4[k], o1["m"][k]) for k in m4]
        assert max(errs) <= M_TOL, (name, errs)


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
@pytest.mark.parametrize("window", [None, 16])
def test_four_rank_split_kv_decode_matches_reference(four_ranks, mesh,
                                                     window):
    from repro.distributed.collectives import decode_attention_ref

    inp, _, res = four_ranks
    ref = decode_attention_ref(jnp.asarray(inp["q"]), jnp.asarray(inp["k"]),
                               jnp.asarray(inp["v"]),
                               jnp.int32(inp["cache_len"]), window=window)
    got = res[f"kv_{mesh}_{window}"]
    assert got.shape == ref.shape
    assert float(np.max(np.abs(got - np.asarray(ref)))) < 1e-5


def test_split_kv_decode_one_rank_is_the_port_oracle():
    from repro_torch.distributed.collectives import (
        decode_attention_ref, make_split_kv_decode,
    )
    from repro_torch.launch.mesh import make_host_mesh

    rng = np.random.default_rng(3)
    q, k, v = _t(rng.standard_normal((1, 1, 4, 8)).astype(np.float32),
                 rng.standard_normal((1, 32, 2, 8)).astype(np.float32),
                 rng.standard_normal((1, 32, 2, 8)).astype(np.float32))
    fn = make_split_kv_decode(make_host_mesh(), ("model",), window=8)
    got = fn(q, k, v, 20)
    want = decode_attention_ref(q, k, v, 20, window=8)
    assert float((got - want).abs().max()) < 1e-6
