"""The port's SSO training engine vs the reference package, on the CPU.

Same graph, plan inputs, features, labels and weights (converted with
``params_from_jax``) go through the reference ``SSOEngine`` and the port's.
Properties:

- port vs reference: loss within 1e-4 relative and gradients within 5e-4
  max-relative (the tolerance ``tests/test_engine_equivalence.py`` holds
  the reference engine to against its oracle: float32 reassociation across
  XLA:CPU and ATen), in regather and snapshot mode, and the same storage
  read/write, host-gather and host-scatter bytes — with a roomy cache and
  with a 96 KB one that evicts and spills;
- the port against its own dense whole-graph autograd oracle on a 3-layer
  GCN, same tolerance;
- inside the port, pipelined == serial BITWISE at depths 1 and 2, with 1
  and 2 gather workers and the transfer stage on and off, in every kernel
  mode (the kernels' plain versions run on the CPU) and in snapshot mode;
  ``kernel`` == ``reference`` bitwise;
- faults: a pipelined epoch under seeded transient storage faults equals
  the clean serial epoch bitwise, and a fatal fault unwinds with no cache
  pin and no pooled buffer left.
"""
import gc
import tempfile
import time

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
from repro_torch.core.faults import FaultPolicy, FaultyTier
from repro_torch.core.plan import build_plan
from repro_torch.core.storage import RetryPolicy, StorageError, StorageTier
from repro_torch.graph.csr import CSRGraph
from repro_torch.models.gnn.layers import (
    full_graph_loss, full_graph_topo, get_gnn,
)
from repro_torch.params import grads_to_jax, params_from_jax
from repro_torch.runtime import PipelineConfig

DIMS = [24, 32, 10]
BYTE_COUNTERS = ("storage_read_bytes", "storage_write_bytes",
                 "host_gather_bytes", "host_scatter_bytes")
_FAST_RETRY = RetryPolicy(max_retries=8, backoff_s=1e-4, backoff_max_s=1e-3,
                          op_deadline_s=5.0)


@pytest.fixture(scope="module")
def setup():
    g = add_self_loops(kronecker_graph(900, 7, seed=0))
    parts = switching_aware_partition(g, 5, max_iters=8, seed=0).parts
    ew = gcn_norm_coeffs(g)
    jplan = jax_build_plan(g, parts, 5, edge_weight=ew)
    pg = CSRGraph(g.indptr.copy(), g.indices.copy(), g.n_nodes)
    plan = build_plan(pg, parts, 5, edge_weight=ew, device="cpu")
    X = random_features(g.n_nodes, DIMS[0], 0)[jplan.ro.perm]
    Y = random_labels(g.n_nodes, DIMS[-1], 0)[jplan.ro.perm]
    jparams = jax_get_gnn("gcn").init(jax.random.PRNGKey(0), DIMS[0],
                                      DIMS[1], DIMS[-1], 2)
    jparams = [jax.tree_util.tree_map(np.asarray, p) for p in jparams]
    return jplan, plan, X, Y, jparams


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Reference engine runs, computed once per (mode, cache budget)."""
    jplan, _, X, Y, jparams = setup
    memo = {}

    def get(mode, budget_kb):
        key = (mode, budget_kb)
        if key not in memo:
            c = JCounters()
            st = JStorageTier(tempfile.mkdtemp(), counters=c)
            eng = JSSOEngine(
                jax_get_gnn("gcn"), jplan, DIMS, st,
                JHostCache(budget_kb << 10, st, c), c, mode=mode,
                pipeline=JPipelineConfig(depth=0, kernels="reference"),
            )
            eng.initialize(X)
            loss, grads = eng.run_epoch(jparams, Y)
            eng.close()
            st.close()
            memo[key] = (loss, jax.tree.map(np.asarray, grads), c)
        return memo[key]

    return get


def _port_run(plan, X, Y, params, dims=DIMS, mode="regather", depth=0,
              workers=1, transfer=True, kernels="reference", budget_kb=65536,
              tier=None):
    c = tier.counters if tier is not None else Counters()
    st = tier if tier is not None else StorageTier(tempfile.mkdtemp(),
                                                   counters=c)
    eng = SSOEngine(
        get_gnn("gcn"), plan, dims, st, HostCache(budget_kb << 10, st, c), c,
        mode=mode, device="cpu",
        pipeline=PipelineConfig(depth=depth, gather_workers=workers,
                                transfer_stage=transfer, kernels=kernels),
    )
    eng.initialize(X)
    loss, grads = eng.run_epoch(params, Y)
    pool = eng._rt.pool
    eng.close()
    st.close()
    assert pool.outstanding == 0
    return loss, grads, c


def _max_rel(want, got):
    errs = []
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        errs.append(np.max(np.abs(w - g)) / (np.max(np.abs(w)) + 1e-12))
    return max(errs)


def _assert_same(a, b):
    (la, ga), (lb, gb) = a[:2], b[:2]
    assert la == lb
    assert len(ga) == len(gb)
    for x, y in zip(ga, gb):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


@pytest.fixture(scope="module")
def port_params(setup):
    return params_from_jax(setup[4], device="cpu")


# ------------------------------------------------------------ vs reference
@pytest.mark.parametrize("mode", ["regather", "snapshot"])
def test_port_engine_matches_reference_engine(setup, jax_runs, port_params,
                                              mode):
    _, plan, X, Y, _ = setup
    jloss, jgrads, _ = jax_runs(mode, 65536)
    loss, grads, _ = _port_run(plan, X, Y, port_params, mode=mode)
    assert np.isfinite(loss)
    assert abs(loss - jloss) <= 1e-4 * max(1.0, abs(jloss))
    assert _max_rel(jgrads, grads_to_jax(grads)) < 5e-4


@pytest.mark.parametrize("mode,budget_kb", [
    ("regather", 65536), ("snapshot", 65536), ("regather", 96),
])
def test_byte_counters_match_reference_engine(setup, jax_runs, port_params,
                                              mode, budget_kb):
    _, plan, X, Y, _ = setup
    jloss, jgrads, jc = jax_runs(mode, budget_kb)
    loss, grads, c = _port_run(plan, X, Y, port_params, mode=mode,
                               budget_kb=budget_kb)
    for f in BYTE_COUNTERS:
        assert getattr(c, f) == getattr(jc, f), f
    if budget_kb == 96:
        # below one layer's activations: eviction and grad spill engage,
        # and the math does not change
        assert c.cache_evictions > 0
        assert abs(loss - jloss) <= 1e-4 * max(1.0, abs(jloss))
        assert _max_rel(jgrads, grads_to_jax(grads)) < 5e-4


def test_port_engine_matches_dense_oracle_three_layers(setup):
    _, plan, X, Y, _ = setup
    dims = [24, 32, 32, 10]
    spec = get_gnn("gcn")
    params = spec.init(torch.Generator().manual_seed(1), 24, 32, 10, 3,
                       device="cpu")
    rg = plan.ro.graph
    topo = full_graph_topo(rg.indptr, rg.indices, rg.n_nodes,
                           plan.edge_weight, device="cpu")
    want = full_graph_loss(spec, params, X, topo, Y)
    want.backward()
    want = want.detach()
    loss, grads, _ = _port_run(plan, X, Y, params, dims=dims)
    assert abs(loss - float(want)) <= 1e-4 * max(1.0, abs(float(want)))
    for layer, g in zip(params, grads):
        for name, p in layer.named_parameters():
            err = (p.grad - g[name]).abs().max() / p.grad.abs().max()
            assert float(err) < 5e-4, name


# ------------------------------------------------------------ inside the port
@pytest.fixture(scope="module")
def serial_runs(setup, port_params):
    _, plan, X, Y, _ = setup
    memo = {}

    def get(kernels, mode):
        if (kernels, mode) not in memo:
            memo[kernels, mode] = _port_run(plan, X, Y, port_params,
                                            mode=mode, kernels=kernels)
        return memo[kernels, mode]

    return get


@pytest.mark.parametrize("depth,workers,transfer", [
    (1, 1, True), (2, 2, True), (2, 1, False), (1, 2, False),
])
@pytest.mark.parametrize("kernels,mode", [
    ("reference", "regather"), ("kernel", "regather"),
    ("kernel-fused", "regather"), ("reference", "snapshot"),
])
def test_pipelined_equals_serial_bitwise(setup, port_params, serial_runs,
                                         kernels, mode, depth, workers,
                                         transfer):
    _, plan, X, Y, _ = setup
    got = _port_run(plan, X, Y, port_params, mode=mode, depth=depth,
                    workers=workers, transfer=transfer, kernels=kernels)
    _assert_same(serial_runs(kernels, mode), got)
    assert got[2].stage_busy_seconds.get("gather", 0.0) > 0.0


def test_kernel_equals_reference_bitwise(serial_runs):
    _assert_same(serial_runs("reference", "regather"),
                 serial_runs("kernel", "regather"))
    # the fused forward moves the activations by ~1 ulp (FMA); the backward
    # is the reference's at those activations
    lr, gr, _ = serial_runs("reference", "regather")
    lf, gf, _ = serial_runs("kernel-fused", "regather")
    assert abs(lr - lf) <= 1e-4 * max(1.0, abs(lr))
    assert _max_rel(grads_to_jax(gr), grads_to_jax(gf)) < 5e-4


# ------------------------------------------------------------------ faults
def test_faulted_pipelined_epoch_bit_identical_to_clean_serial(
    setup, port_params, serial_runs,
):
    """Seeded transient faults (read and write errors, read corruption, a
    scheduled torn write, latency spikes) under depth 2, 2 gather workers
    and the transfer stage: the loss and grads equal the fault-free serial
    run bitwise, and the retries show in the metrics."""
    _, plan, X, Y, _ = setup
    policy = FaultPolicy(
        seed=1, read_error_rate=0.01, write_error_rate=0.01,
        read_corrupt_rate=0.005, latency_spike_rate=0.002,
        latency_spike_s=0.001,
    )
    policy.schedule("write", 3, "torn")
    policy.schedule("read", 2, "latency")
    policy.schedule("read", 4, "error")
    c = Counters()
    tier = FaultyTier(tempfile.mkdtemp(), policy=policy, counters=c,
                      verify_reads=True, retry=_FAST_RETRY)
    got = _port_run(plan, X, Y, port_params, depth=2, workers=2, tier=tier)
    _assert_same(serial_runs("reference", "regather"), got)
    assert policy.n_injected >= 3
    assert float(c.metrics.get("io.retries").value) > 0
    assert float(c.metrics.get("io.faults_injected").value) == \
        policy.n_injected


@pytest.mark.parametrize("kernels", ["reference", "kernel"])
def test_unrecoverable_fault_unwinds_engine_cleanly(setup, port_params,
                                                    kernels):
    """A fatal (non-retryable) storage fault mid-epoch: run_epoch raises
    the typed error within bounded wall-clock, every cache pin and pooled
    buffer is released, and close() still terminates."""
    _, plan, X, Y, _ = setup
    policy = FaultPolicy(seed=0).schedule("read", 2, "enospc")
    c = Counters()
    st = FaultyTier(tempfile.mkdtemp(), policy=policy, counters=c,
                    retry=_FAST_RETRY)
    cache = HostCache(8 << 20, st, c)
    eng = SSOEngine(
        get_gnn("gcn"), plan, DIMS, st, cache, c, device="cpu",
        pipeline=PipelineConfig(depth=2, gather_workers=2,
                                transfer_stage=True, kernels=kernels),
    )
    eng.initialize(X)         # writes only: the scheduled read fault
    t0 = time.perf_counter()  # fires inside the epoch's prefetch/gather
    with pytest.raises(StorageError):
        eng.run_epoch(port_params, Y)
    assert time.perf_counter() - t0 < 30.0
    assert cache.total_pins == 0
    gc.collect()
    assert eng._rt.pool.outstanding == 0
    t0 = time.perf_counter()
    eng.close()
    assert time.perf_counter() - t0 < 10.0
    st.close()
