"""The port's serving slice as a whole vs the reference package.

Same graph, plan inputs, features and weights (converted with
``params_from_jax``) go through the reference ``OffloadedInference`` and the
port's, on the CPU. Properties:

- port vs reference final table: max relative error <= 1e-4 (float32
  reassociation across XLA:CPU and ATen, compounded over the layers);
- inside the port, pipelined (depth 2, transfer stage on) == serial and
  ``kernel`` == ``reference`` BITWISE; ``kernel-fused`` within 1e-4;
- the same config moves the same storage and host-gather bytes;
- ``EmbeddingServer`` lookups match a dense whole-graph forward;
- the port's ``launch.infer`` smoke passes all its checks.
"""
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.core import Counters as JCounters
from repro.core import HostCache as JHostCache
from repro.core import StorageTier as JStorageTier
from repro.core import build_plan as jax_build_plan
from repro.graph import (
    gcn_norm_coeffs, kronecker_graph, switching_aware_partition,
)
from repro.graph.csr import add_self_loops
from repro.graph.synthetic import random_features
from repro.infer import OffloadedInference as JOffloadedInference
from repro.models.gnn.layers import get_gnn as jax_get_gnn
from repro.runtime import PipelineConfig as JPipelineConfig

from repro_torch.core.cache import HostCache
from repro_torch.core.counters import Counters
from repro_torch.core.plan import build_plan
from repro_torch.core.storage import StorageTier
from repro_torch.graph.csr import CSRGraph
from repro_torch.infer import EmbeddingServer, OffloadedInference
from repro_torch.launch.infer import _infer_smoke
from repro_torch.models.gnn.layers import (
    full_graph_forward, full_graph_topo, get_gnn,
)
from repro_torch.params import params_from_jax
from repro_torch.runtime import PipelineConfig

DIMS = [16, 32, 8]
BYTE_COUNTERS = ("storage_read_bytes", "storage_write_bytes",
                 "host_gather_bytes")


@pytest.fixture(scope="module")
def setup():
    g = add_self_loops(kronecker_graph(900, 7, seed=0))
    parts = switching_aware_partition(g, 5, max_iters=8, seed=0).parts
    ew = gcn_norm_coeffs(g)
    jplan = jax_build_plan(g, parts, 5, edge_weight=ew)
    pg = CSRGraph(g.indptr.copy(), g.indices.copy(), g.n_nodes)
    plan = build_plan(pg, parts, 5, edge_weight=ew, device="cpu")
    X = random_features(g.n_nodes, DIMS[0], 0)[jplan.ro.perm]
    spec = jax_get_gnn("gcn")
    jparams = spec.init(jax.random.PRNGKey(0), DIMS[0], DIMS[1], DIMS[-1], 2)
    params = params_from_jax(
        [jax.tree_util.tree_map(np.asarray, p) for p in jparams],
        device="cpu")
    return jplan, plan, X, jparams, params


def _jax_run(jplan, X, jparams, depth, budget_kb=4096):
    c = JCounters()
    st = JStorageTier(tempfile.mkdtemp(), counters=c)
    inf = JOffloadedInference(
        jax_get_gnn("gcn"), jplan, DIMS, st, JHostCache(budget_kb << 10, st, c),
        c, pipeline=JPipelineConfig(depth=depth, kernels="reference"),
    )
    inf.initialize(X)
    name = inf.run(jparams)
    emb = st.read_rows(name, 0, jplan.n_nodes)
    inf.close()
    st.close()
    return emb, c


def _port_run(plan, X, params, depth, kernels, budget_kb=4096, keep=False):
    c = Counters()
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    inf = OffloadedInference(
        get_gnn("gcn"), plan, DIMS, st, HostCache(budget_kb << 10, st, c), c,
        pipeline=PipelineConfig(depth=depth, kernels=kernels), device="cpu",
    )
    inf.initialize(X)
    name = inf.run(params)
    emb = st.read_rows(name, 0, plan.n_nodes)
    pool = inf._rt.pool
    inf.close()
    assert pool.outstanding == 0
    if keep:
        return emb, c, st
    st.close()
    return emb, c


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(a))


def test_port_matches_reference_and_is_bitwise_across_modes(setup):
    jplan, plan, X, jparams, params = setup
    want, _ = _jax_run(jplan, X, jparams, 0)
    outs = {}
    for kernels in ("reference", "kernel", "kernel-fused"):
        for depth in (0, 2):
            emb, c = _port_run(plan, X, params, depth, kernels)
            outs[kernels, depth] = emb
            if depth:
                # the pipeline stages really ran on workers
                assert c.stage_busy_seconds.get("gather", 0.0) > 0.0
                assert c.stage_busy_seconds.get("h2d", 0.0) > 0.0
    ref0 = outs["reference", 0]
    assert np.all(np.isfinite(ref0))
    assert _rel(want, ref0) <= 1e-4
    for kernels in ("reference", "kernel", "kernel-fused"):
        np.testing.assert_array_equal(outs[kernels, 2], outs[kernels, 0])
    np.testing.assert_array_equal(outs["kernel", 0], ref0)
    assert _rel(ref0, outs["kernel-fused", 0]) <= 1e-4


@pytest.mark.parametrize("budget_kb", [4096, 16])
def test_byte_counters_match_reference(setup, budget_kb):
    jplan, plan, X, jparams, params = setup
    _, jc = _jax_run(jplan, X, jparams, 0, budget_kb)
    _, c = _port_run(plan, X, params, 0, "reference", budget_kb)
    for f in BYTE_COUNTERS:
        assert getattr(c, f) == getattr(jc, f), f
    if budget_kb == 16:
        assert c.cache_evictions + c.cache_bypass > 0


def test_server_lookups_match_dense_forward(setup):
    jplan, plan, X, jparams, params = setup
    _, _, st = _port_run(plan, X, params, 2, "kernel", keep=True)
    rg = plan.ro.graph
    topo = full_graph_topo(rg.indptr, rg.indices, rg.n_nodes,
                           plan.edge_weight, device="cpu")
    with torch.no_grad():
        ref = full_graph_forward(get_gnn("gcn"), params, X, topo).numpy()
    srv = EmbeddingServer(st, "emb", plan.ro, 1 << 20, block_rows=64)
    rng = np.random.default_rng(0)
    for _ in range(4):
        ids = rng.integers(0, plan.n_nodes, 48)
        np.testing.assert_allclose(srv.lookup(ids), ref[plan.ro.inv_perm[ids]],
                                   rtol=1e-4, atol=1e-5)
    s = srv.stats()
    assert s["rows_served"] == 4 * 48 and 0.0 <= s["hit_rate"] <= 1.0
    srv.close()
    st.close()


def test_fp16_storage_and_truncation(setup):
    jplan, plan, X, jparams, params = setup
    ref, _ = _port_run(plan, X, params, 0, "reference")
    c = Counters()
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    inf = OffloadedInference(
        get_gnn("gcn"), plan, DIMS, st, HostCache(4 << 20, st, c), c,
        pipeline=PipelineConfig(depth=2), store_dtype=np.float16,
        keep_input=False, device="cpu",
    )
    inf.initialize(X)
    name = inf.run(params)
    emb = st.read_rows(name, 0, plan.n_nodes)
    assert emb.dtype == np.float16
    assert not st.exists("act0") and not st.exists("act1")
    np.testing.assert_allclose(emb.astype(np.float32), ref, rtol=2e-2,
                               atol=2e-2)
    inf.close()
    st.close()


@pytest.mark.parametrize("kernels", ["auto", "kernel-fused"])
def test_launch_smoke_passes_all_checks(kernels):
    r = _infer_smoke("gcn", 2, device="cpu", queries=4, kernels=kernels)
    assert r["finite"] and r["pipeline_matches_serial"]
    assert r["serve_matches_table"] and r["serve_matches_dense"]
    assert r["queries"] == 4 and r["kernels"] == kernels
    assert sorted(r["runs"]) == [0, 2]
    for run in r["runs"].values():
        assert run["table"].shape == (2000, 8)
        assert run["counters"].storage_read_bytes > 0
