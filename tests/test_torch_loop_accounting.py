"""The port's account of its own time (``runtime/accounting.py``), on the CPU
(one case on the card, marked ``cuda``):

- the compute loop's states (``Counters.loop_*_ns``) plus its
  ``compute_wait_*`` stalls add up to the wall of ``SSOEngine.run_epoch``
  within 10%, for GCN and GAT, serial and pipelined, in the reference and the
  kernel route; likewise for ``OffloadedInference.run``;
- every storage-tier read path adds to ``storage_read_ns`` and observes the
  ``storage.read_seconds`` histogram once, from whichever thread reads, so
  over an epoch the histogram counts ``storage_read_ops``;
- the gather and the stacked gather time their copies (``host_copy_ns``);
- with the tracer off no CUDA event is built and no thread CPU time or
  rusage is read, and the tracer-only fields stay 0; the device clock arms
  only with the tracer on, on a card, and adds each bracket's elapsed time;
- the tracer leaves the byte, H2D and cache counters as they are.
"""
import resource
import tempfile
import time

import numpy as np
import pytest
import torch

from repro_torch.core.cache import HostCache
from repro_torch.core.counters import Counters
from repro_torch.core.engine import SSOEngine
from repro_torch.core.plan import build_plan
from repro_torch.core.storage import StorageIOQueue, StorageTier
from repro_torch.graph.csr import add_self_loops, gcn_norm_coeffs
from repro_torch.graph.partition import switching_aware_partition
from repro_torch.graph.synthetic import (
    kronecker_graph, random_features, random_labels,
)
from repro_torch.infer import OffloadedInference
from repro_torch.models.gnn.layers import get_gnn
from repro_torch.obs import NULL_TRACER, Tracer
from repro_torch.runtime import PipelineConfig
from repro_torch.runtime.accounting import LOOP_STATES, DeviceClock

DIMS = [24, 32, 32, 10]
N_PARTS = 5
TRACER_ONLY = ("gather_cpu_ns", "gather_nivcsw", "gather_majflt",
               "device_fwd_ns", "device_loss_ns", "device_bwd_ns")
KEPT = ("storage_read_bytes", "storage_read_ops", "h2d_bytes", "cache_hits",
        "cache_misses", "host_gather_bytes", "host_scatter_bytes")


@pytest.fixture(scope="module")
def graph():
    g = add_self_loops(kronecker_graph(900, 7, seed=0))
    parts = switching_aware_partition(g, N_PARTS, max_iters=8, seed=0).parts
    return g, parts


def make_engine(graph, model, depth, kernels="reference", infer=False,
                device="cpu", counters=None):
    g, parts = graph
    ew = gcn_norm_coeffs(g) if model == "gcn" else None
    plan = build_plan(g, parts, N_PARTS, edge_weight=ew, device=device)
    c = counters if counters is not None else Counters()
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    cache = HostCache(1 << 16, st, c)   # a spilling cache: storage reads
    cls = OffloadedInference if infer else SSOEngine
    eng = cls(get_gnn(model), plan, DIMS, st, cache, c,
              pipeline=PipelineConfig(depth=depth, kernels=kernels),
              device=device)
    eng.initialize(random_features(g.n_nodes, DIMS[0], 0)[plan.ro.perm])
    spec = get_gnn(model)
    params = spec.init(torch.Generator().manual_seed(0), DIMS[0], DIMS[1],
                       DIMS[-1], len(DIMS) - 1, device=device)
    labels = random_labels(g.n_nodes, DIMS[-1], 0)[plan.ro.perm]
    return eng, st, c, params, labels


def run(eng, params, labels):
    if isinstance(eng, OffloadedInference):
        return eng.run(params)
    return eng.run_epoch(params, labels)


def account(c):
    """``({state: seconds}, compute_wait seconds)`` so far."""
    states = {s: getattr(c, f"loop_{s}_ns") / 1e9 for s in LOOP_STATES}
    wait = sum(v for k, v in c.stage_stall_seconds.items()
               if k.startswith("compute_wait"))
    return states, wait


def timed_run(eng, c, params, labels):
    """One run after a warm-up one: its wall, its states and its waits."""
    run(eng, params, labels)
    s0, w0 = account(c)
    t0 = time.perf_counter()
    run(eng, params, labels)
    wall = time.perf_counter() - t0
    s1, w1 = account(c)
    return wall, {s: s1[s] - s0[s] for s in s1}, w1 - w0


def assert_closes(wall, states, wait, depth):
    total = sum(states.values()) + wait
    assert abs(total - wall) <= 0.10 * wall, (wall, states, wait)
    assert all(v >= 0 for v in states.values())
    assert states["launch"] > 0
    if depth == 0:
        # the stages run inline on the compute thread: no unit waits
        assert states["fetch"] > 0 and wait == 0
    else:
        # the transfer stage stages every unit: nothing runs inline
        assert states["fetch"] == 0


@pytest.mark.parametrize("kernels", ["reference", "kernel"])
@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_loop_states_close_the_epoch(graph, model, depth, kernels):
    eng, st, c, params, labels = make_engine(graph, model, depth, kernels)
    try:
        wall, states, wait = timed_run(eng, c, params, labels)
    finally:
        eng.close()
        st.close()
    assert_closes(wall, states, wait, depth)
    assert states["scatter"] > 0 and states["barrier"] > 0


@pytest.mark.parametrize("depth", [0, 2])
def test_loop_states_close_the_refresh(graph, depth):
    eng, st, c, params, labels = make_engine(graph, "gcn", depth, infer=True)
    try:
        wall, states, wait = timed_run(eng, c, params, labels)
    finally:
        eng.close()
        st.close()
    assert_closes(wall, states, wait, depth)
    assert states["scatter"] == 0   # forward only: no ∇A write-back


# ------------------------------------------------------------------ storage
def _read(path, st, q):
    if path == "read_rows":
        st.read_rows("a", 3, 40)
    elif path == "batched":
        st.read_rows_batched([("a", 0, 10), ("a", 20, 30)])
    elif path == "scattered_one_run":
        st.read_rows_scattered("a", np.arange(5, 12))
    elif path == "scattered_three_runs":
        st.read_rows_scattered("a", np.array([1, 2, 7, 30, 31]))
    elif path == "queue":
        q.submit_read("a", 0, 64).result()
    else:
        q.submit_read_batch([("a", 0, 8), ("a", 9, 12)]).result()


@pytest.mark.parametrize("path,ops", [
    ("read_rows", 1), ("batched", 1), ("scattered_one_run", 1),
    ("scattered_three_runs", 3), ("queue", 1), ("queue_batch", 1)])
def test_every_read_path_is_timed_once(path, ops, rng):
    """One read, one observation of its time: the tier times it (retries
    included) into ``storage_read_ns`` and ``storage.read_seconds``, and the
    I/O queue observes nothing of its own. A scattered read counts one op
    per contiguous run but is one call, so one observation."""
    c = Counters()
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    q = StorageIOQueue(st, counters=c)
    try:
        st.alloc("a", (64, 8), np.float32)
        st.write_rows("a", 0, rng.standard_normal((64, 8)).astype(np.float32))
        hist = c.metrics.histogram("storage.read_seconds")
        n0, ops0, ns0 = hist.snapshot()["count"], c.storage_read_ops, \
            c.storage_read_ns
        _read(path, st, q)
        assert hist.snapshot()["count"] == n0 + 1
        assert c.storage_read_ops == ops0 + ops
        assert c.storage_read_ns > ns0
        assert hist.snapshot()["sum"] == pytest.approx(
            c.storage_read_ns / 1e9, rel=1e-6)
    finally:
        q.close()
        st.close()


@pytest.mark.parametrize("depth", [0, 2])
def test_read_histogram_counts_every_read_of_an_epoch(graph, depth):
    """Gather and prefetch workers read the tier directly; their reads are
    in the histogram as the I/O queue's are."""
    eng, st, c, params, labels = make_engine(graph, "gcn", depth)
    try:
        run(eng, params, labels)
    finally:
        eng.close()
        st.close()
    hist = c.metrics.snapshot()["storage.read_seconds"]
    assert c.storage_read_ops > 0 and hist["count"] == c.storage_read_ops
    assert hist["sum"] == pytest.approx(c.storage_read_ns / 1e9, rel=1e-6)


@pytest.mark.parametrize("which", ["gather", "stacked_gather"])
def test_host_copy_ns_grows_with_the_gathers(graph, which):
    eng, st, c, _, _ = make_engine(graph, "gcn", 0)
    runner = eng.fwd_runner
    try:
        for p in range(N_PARTS):
            u = runner.plan.unit(p)
            ns0, b0 = c.host_copy_ns, c.host_gather_bytes
            if which == "gather":
                buf = runner.gather(0, u, u.r_pad)
            else:
                buf = runner.stacked_gather(0, u).stack
            eng._rt.pool.release(buf)
            assert c.host_copy_ns > ns0 and c.host_gather_bytes > b0
    finally:
        eng.close()
        st.close()


# ------------------------------------------------------------------- tracer
def _refuse(*_a, **_k):
    raise AssertionError("called with the tracer off")


@pytest.mark.parametrize("depth", [0, 2])
def test_tracer_off_reads_no_usage_and_builds_no_event(graph, depth,
                                                       monkeypatch):
    eng, st, c, params, labels = make_engine(graph, "gcn", depth, "kernel")
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(resource, "getrusage", _refuse)
    monkeypatch.setattr(time, "thread_time_ns", _refuse)
    try:
        assert c.tracer is NULL_TRACER
        run(eng, params, labels)
        run(eng, params, labels)
    finally:
        eng.close()
        st.close()
    assert all(getattr(c, f) == 0 for f in TRACER_ONLY)
    assert c.loop_launch_ns > 0 and c.storage_read_ns > 0
    assert c.host_copy_ns > 0


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_tracer_leaves_the_existing_counters_alone(graph, model):
    """Two engines over the same inputs, one traced: the same bytes, H2D,
    cache hits and misses; the traced one's workers account their CPU time
    and every state emits ``loop:<state>`` spans."""
    got = {}
    for traced in (False, True):
        c = Counters()
        if traced:
            c.tracer = Tracer()
        eng, st, c, params, labels = make_engine(graph, model, 2,
                                                 counters=c)
        try:
            run(eng, params, labels)
            run(eng, params, labels)
        finally:
            eng.close()
            st.close()
        got[traced] = c
    off, on = got[False], got[True]
    assert {f: getattr(off, f) for f in KEPT} == \
        {f: getattr(on, f) for f in KEPT}
    assert on.gather_cpu_ns > 0 and off.gather_cpu_ns == 0
    spans = {e["name"] for e in on.tracer.events() if e["ph"] == "X"}
    assert {"loop:launch", "loop:scatter", "loop:write",
            "loop:barrier"} <= spans


class FakeEvent:
    """A CUDA event on a host clock: ``elapsed_time`` in ms."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.mark.parametrize("device,traced,arms", [
    ("cuda", False, False), ("cpu", True, False), ("cuda", True, True)])
def test_device_clock_arms_only_traced_on_a_card(monkeypatch, device,
                                                 traced, arms):
    """The arming rule, with stand-ins for the CUDA event and stream; armed,
    each pass's brackets add up into its field and the events are reused
    from the pool."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)
    FakeEvent.made = 0
    c = Counters()
    if traced:
        c.tracer = Tracer()
    clock = DeviceClock(c, torch.device(device))
    for _ in range(2):
        clock.arm()
        for which in ("fwd", "fwd", "loss", "bwd"):
            clock.start()
            time.sleep(0.002)
            clock.stop(which)
        clock.resolve()
    assert clock.armed == arms
    if not arms:
        assert FakeEvent.made == 0
        assert c.device_fwd_ns == c.device_loss_ns == c.device_bwd_ns == 0
        return
    assert FakeEvent.made == 8   # the second run reuses the first's events
    assert c.device_fwd_ns >= 2 * 2 * 2_000_000
    assert c.device_loss_ns >= 2 * 2_000_000
    assert c.device_bwd_ns >= 2 * 2_000_000


@pytest.mark.cuda
def test_device_fwd_ns_lies_within_the_epoch_on_the_card(graph):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = Counters()
    c.tracer = Tracer()
    eng, st, c, params, labels = make_engine(graph, "gcn", 2, "auto",
                                             device="cuda", counters=c)
    try:
        run(eng, params, labels)
        f0 = c.device_fwd_ns
        t0 = time.perf_counter_ns()
        run(eng, params, labels)
        wall = time.perf_counter_ns() - t0
    finally:
        eng.close()
        st.close()
    assert 0 < c.device_fwd_ns - f0 < wall
    assert c.device_loss_ns > 0 and c.device_bwd_ns > 0
