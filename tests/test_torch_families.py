"""The port's SSO training engine for the five families beyond GCN (``sage``,
``gat``, ``gin``, ``pna``, ``graphcast``) vs the reference ``SSOEngine``, on
the CPU.

Setup as the reference's own family test (``tests/test_engine_equivalence``):
a 1200-node Kronecker graph with self-loops, 6 switching-aware partitions,
dims [24, 32, 10], reference weights from ``PRNGKey(0)`` converted with
``params_from_jax``. Properties:

- port vs reference, in regather and snapshot mode: loss within 1e-4
  relative and every gradient within 5e-4 max-relative (float32
  reassociation across XLA:CPU and ATen, over two layers and their vjps),
  and equal storage read/write, host-gather and host-scatter bytes;
- inside the port, ``kernel`` == ``reference`` bitwise (the kernels' plain
  versions run on the CPU; the layer sees the same ``GA``);
- GAT in ``kernel-fused`` (its softmax through the ``edge_softmax``
  wrapper) within the same tolerance of the reference engine.

Pipelined == serial and offloaded GAT inference:
``tests/test_torch_families_pipeline.py``.
"""
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.core import Counters as JCounters
from repro.core import HostCache as JHostCache
from repro.core import SSOEngine as JSSOEngine
from repro.core import StorageTier as JStorageTier
from repro.core import build_plan as jax_build_plan
from repro.graph import (
    gcn_norm_coeffs, kronecker_graph, switching_aware_partition,
)
from repro.graph.csr import add_self_loops
from repro.graph.synthetic import random_features, random_labels
from repro.models.gnn.layers import get_gnn as jax_get_gnn
from repro.runtime import PipelineConfig as JPipelineConfig

from repro_torch.core.cache import HostCache
from repro_torch.core.counters import Counters
from repro_torch.core.engine import SSOEngine
from repro_torch.core.plan import build_plan
from repro_torch.core.storage import StorageTier
from repro_torch.graph.csr import CSRGraph
from repro_torch.models.gnn.layers import get_gnn
from repro_torch.params import grads_to_jax, params_from_jax
from repro_torch.runtime import PipelineConfig

FAMILIES = ["sage", "gat", "gin", "pna", "graphcast"]
DIMS = [24, 32, 10]
BYTE_COUNTERS = ("storage_read_bytes", "storage_write_bytes",
                 "host_gather_bytes", "host_scatter_bytes")


def make_setup(n_nodes=1200, n_parts=6, seed=0):
    """The reference family test's graph, plan, features and labels, for
    both packages (``jplan``, ``plan``)."""
    g = add_self_loops(kronecker_graph(n_nodes, 7, seed=seed))
    parts = switching_aware_partition(g, n_parts, max_iters=10,
                                      seed=seed).parts
    ew = gcn_norm_coeffs(g)
    jplan = jax_build_plan(g, parts, n_parts, edge_weight=ew)
    pg = CSRGraph(g.indptr.copy(), g.indices.copy(), g.n_nodes)
    plan = build_plan(pg, parts, n_parts, edge_weight=ew, device="cpu")
    X = random_features(g.n_nodes, DIMS[0], seed)[jplan.ro.perm]
    Y = random_labels(g.n_nodes, DIMS[-1], seed)[jplan.ro.perm]
    return jplan, plan, X, Y


def jax_params(model):
    p = jax_get_gnn(model).init(jax.random.PRNGKey(0), DIMS[0], DIMS[1],
                                DIMS[-1], len(DIMS) - 1)
    return [jax.tree_util.tree_map(np.asarray, layer) for layer in p]


def port_run(model, plan, X, Y, params, mode="regather", depth=0, workers=1,
             kernels="reference", budget_kb=65536):
    c = Counters()
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    eng = SSOEngine(
        get_gnn(model), plan, DIMS, st, HostCache(budget_kb << 10, st, c), c,
        mode=mode, device="cpu",
        pipeline=PipelineConfig(depth=depth, gather_workers=workers,
                                kernels=kernels),
    )
    eng.initialize(X)
    loss, grads = eng.run_epoch(params, Y)
    pool = eng._rt.pool
    eng.close()
    st.close()
    assert pool.outstanding == 0
    return loss, grads, c


def assert_same(a, b):
    (la, ga), (lb, gb) = a[:2], b[:2]
    assert la == lb
    assert len(ga) == len(gb)
    for x, y in zip(ga, gb):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


def max_rel(want, got):
    errs = []
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        errs.append(np.max(np.abs(w - g)) / (np.max(np.abs(w)) + 1e-12))
    return max(errs)


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.fixture(scope="module")
def runs(setup):
    """Engine runs, memoised: ``("jax", model, mode)`` is the reference
    engine, ``(kernels, model, mode)`` the port's (serial)."""
    jplan, plan, X, Y = setup
    memo = {}

    def get(key):
        if key not in memo:
            which, model, mode = key
            jp = jax_params(model)
            if which == "jax":
                c = JCounters()
                st = JStorageTier(tempfile.mkdtemp(), counters=c)
                eng = JSSOEngine(
                    jax_get_gnn(model), jplan, DIMS, st,
                    JHostCache(65536 << 10, st, c), c, mode=mode,
                    pipeline=JPipelineConfig(depth=0, kernels="reference"),
                )
                eng.initialize(X)
                loss, grads = eng.run_epoch(jp, Y)
                eng.close()
                st.close()
                memo[key] = (loss, jax.tree.map(np.asarray, grads), c)
            else:
                memo[key] = port_run(model, plan, X, Y,
                                     params_from_jax(jp, device="cpu"),
                                     mode=mode, kernels=which)
        return memo[key]

    return get


@pytest.mark.parametrize("mode", ["regather", "snapshot"])
@pytest.mark.parametrize("model", FAMILIES)
def test_family_engine_matches_reference_engine(runs, model, mode):
    jloss, jgrads, jc = runs(("jax", model, mode))
    loss, grads, c = runs(("reference", model, mode))
    assert np.isfinite(loss)
    assert all(bool(torch.isfinite(t).all()) for g in grads
               for t in g.values())
    assert abs(loss - jloss) <= 1e-4 * max(1.0, abs(jloss))
    assert max_rel(jgrads, grads_to_jax(grads, model=model)) < 5e-4
    for f in BYTE_COUNTERS:
        assert getattr(c, f) == getattr(jc, f), f


@pytest.mark.parametrize("model", FAMILIES)
def test_family_kernel_equals_reference_bitwise(runs, model):
    assert_same(runs(("reference", model, "regather")),
                runs(("kernel", model, "regather")))


def test_gat_kernel_fused_within_tolerance_of_reference(runs):
    jloss, jgrads, _ = runs(("jax", "gat", "regather"))
    loss, grads, c = runs(("kernel-fused", "gat", "regather"))
    assert abs(loss - jloss) <= 1e-4 * max(1.0, abs(jloss))
    assert max_rel(jgrads, grads_to_jax(grads)) < 5e-4
    # the softmax went through the dispatcher's edge_softmax route
    assert c.phase_seconds.get("kernel:edge_softmax.ref", 0.0) > 0.0
    ref_loss, ref_grads, rc = runs(("reference", "gat", "regather"))
    assert "kernel:edge_softmax.ref" not in rc.phase_seconds
    assert abs(loss - ref_loss) <= 1e-4 * max(1.0, abs(ref_loss))
    assert max_rel(grads_to_jax(ref_grads), grads_to_jax(grads)) < 5e-4
