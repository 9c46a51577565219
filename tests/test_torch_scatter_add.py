"""The port's ``scatter_add`` (the backward's ∇A write-back): the plain
version vs the reference Pallas kernel (interpret mode) and the ``np.add.at``
oracle, the dispatcher's host paths vs the reference's, and the wrapper's
refusals.

All comparisons are bitwise: the kernel, its plain version and the oracle
add each value row once, in input order. The CUDA kernel itself is held
against the oracle on the card by ``tests/test_torch_cuda_kernels.py``
(marker ``cuda``) and ``chip_smoke.py``.
"""
import gc
import tempfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.dispatch import scatter_add_rows_ref as jax_scatter_rows_ref
from repro.kernels.gather_scatter import ops as jops
from repro.kernels.gather_scatter import ref as jref

from repro_torch.core.counters import Counters
from repro_torch.kernels.dispatch import KernelDispatch, scatter_add_rows_ref
from repro_torch.kernels.gather_scatter import ops, ref


def _inputs(rng, n, r, D, dup=True):
    base = rng.standard_normal((n, D), dtype=np.float32)
    rows = (rng.integers(0, n, r) if dup
            else rng.choice(n, size=r, replace=False))
    rows = np.sort(rows).astype(np.int32)
    values = rng.standard_normal((r, D), dtype=np.float32)
    return base, rows, values


@pytest.mark.parametrize("n,r,D", [
    (64, 200, 16),     # many duplicates
    (300, 77, 48),
    (10, 1, 7),        # one row, D % 4 != 0
    (40, 90, 7),       # D % 4 != 0 with duplicates
    (257, 511, 130),
    (50, 20, 8),       # rows only in the head: an untouched tail
])
def test_plain_bitwise_vs_oracle_and_reference_kernel(n, r, D, rng):
    base, rows, values = _inputs(rng, n, r, D)
    if (n, r) == (50, 20):
        rows = np.sort(rng.integers(0, 10, r)).astype(np.int32)
    want = jref.scatter_add_ref(base, rows, values)
    np.testing.assert_array_equal(ref.scatter_add_ref_np(base, rows, values),
                                  want)
    pallas = np.asarray(jops.scatter_add(
        jnp.asarray(base), jnp.asarray(rows), jnp.asarray(values),
        interpret=True))
    np.testing.assert_array_equal(pallas, want)
    got = torch.from_numpy(base.copy())
    out = ops.scatter_add_(got, *(torch.from_numpy(a) for a in (rows, values)))
    assert out is got                       # in place
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.scatter_add_ref(torch.from_numpy(base.copy()),
                            torch.from_numpy(rows),
                            torch.from_numpy(values)).numpy(), want)


@pytest.mark.parametrize("R,D", [(0, 8), (4, 0)])
def test_empty_scatter_leaves_base(R, D, rng):
    base = torch.from_numpy(rng.standard_normal((16, D), dtype=np.float32))
    before = base.clone()
    out = ops.scatter_add_(base, torch.zeros(R, dtype=torch.int32),
                           torch.zeros((R, D)))
    assert out is base and torch.equal(base, before)


def test_wrapper_refusals():
    b = torch.zeros(4, 4)
    with pytest.raises(ValueError):
        ops.scatter_add_(b, torch.zeros(2, 2, dtype=torch.int32),
                         torch.zeros(2, 4))
    with pytest.raises(ValueError):
        ops.scatter_add_(torch.zeros(4), torch.zeros(2, dtype=torch.int32),
                         torch.zeros(2, 4))
    with pytest.raises(ValueError, match="do not match"):
        ops.scatter_add_(b, torch.zeros(2, dtype=torch.int32),
                         torch.zeros(3, 4))
    # the launch-side checks (dtype, device, contiguity) of a CUDA base
    with pytest.raises(TypeError):
        ops._check("rows", torch.zeros(2, dtype=torch.int64), torch.int32, 1,
                   torch.device("cpu"))
    with pytest.raises(ValueError, match="expected"):
        ops._check("values", torch.zeros(2, 4), torch.float32, 2,
                   torch.device("meta"))


def test_cpu_tensor_runs_plain_version_and_launches_nothing(rng, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("kernel library touched for a CPU tensor")

    monkeypatch.setattr(ops, "_lib", boom)
    ops.reset_launches()
    base, rows, values = _inputs(rng, 30, 40, 8)
    ops.scatter_add_(*(torch.from_numpy(a) for a in (base, rows, values)))
    assert ops.LAUNCHES["scatter_add"] == 0


# ----------------------------------------------------------------- dispatch
def _row_cases(rng):
    """Row sets of the engine's shapes (sorted unique, contiguous runs, the
    loss layer's arange), plus an unsorted one and an empty one."""
    return {
        "sorted_unique": np.sort(rng.choice(100, 37, replace=False)),
        "contiguous": np.arange(20, 45),
        "arange": np.arange(100),
        "single": np.array([7]),
        "unsorted_unique": rng.choice(100, 30, replace=False),
        "empty": np.zeros(0, np.int64),
    }


@pytest.mark.parametrize("case", ["sorted_unique", "contiguous", "arange",
                                  "single", "unsorted_unique", "empty"])
@pytest.mark.parametrize("mode", ["reference", "kernel"])
def test_dispatch_matches_reference_host_scatter(case, mode, rng):
    rows = _row_cases(rng)[case]
    D = 12
    base = rng.standard_normal((100, D), dtype=np.float32)
    values = rng.standard_normal((rows.size, D), dtype=np.float32)
    want = base.copy()
    jax_scatter_rows_ref(want, rows, values)
    np.testing.assert_array_equal(want,
                                  jref.scatter_add_ref(base, rows, values))
    mine = base.copy()
    scatter_add_rows_ref(mine, rows, values)
    np.testing.assert_array_equal(mine, want)
    c = Counters()
    kd = KernelDispatch(mode, c, device="cpu")
    got = base.copy()
    kd.scatter_add_rows(got, rows, values)
    np.testing.assert_array_equal(got, want)
    if rows.size:
        assert c.phase_seconds["kernel:scatter_add.ref"] > 0


def test_dispatch_unsorted_duplicates_keep_input_order(rng):
    """Unsorted rows with duplicates through the kernel path: the stable
    sort keeps each row's values in input order, so the result is the
    sequential ``np.add.at`` bitwise (the host reduceat path sums a
    segment first and may differ by an ulp)."""
    rows = rng.integers(0, 20, 80)
    base = rng.standard_normal((20, 9), dtype=np.float32)
    values = (rng.standard_normal((80, 9)) * 1e3).astype(np.float32)
    got = base.copy()
    KernelDispatch("kernel", device="cpu").scatter_add_rows(got, rows, values)
    np.testing.assert_array_equal(got, ref.scatter_add_ref_np(base, rows,
                                                              values))


# ------------------------------------------- in place vs round trip (CPU)
class _FakeLocked:
    """Stands in for the card on the CPU: a page-locked probe that says yes
    for the buffers it is told of and for the pool's blocks, a host-mapped
    op that records its calls and adds with the plain version, and
    "registered" blocks of plain numpy memory for ``PageLockedPool`` (each
    unregistration checks that its thread does not hold ``lock``, the
    cache's)."""

    def __init__(self, monkeypatch, lock=None):
        from repro_torch.kernels import dispatch
        from repro_torch.runtime import pinned

        self.locked = set()
        self.calls = []
        self.blocks = {}
        self.registered = 0
        self.lock = lock
        monkeypatch.setattr(dispatch, "_page_locked",
                            lambda buf: _addr(buf) in self.locked
                            or self.owns(buf))
        monkeypatch.setattr(ops, "scatter_add_host_", self._host_op)
        monkeypatch.setattr(pinned, "_register", self._register)
        monkeypatch.setattr(pinned, "_unregister", self._unregister)

    def _host_op(self, base, rows, values):
        self.calls.append((_addr(base.numpy()), rows, values))
        return ref.scatter_add_ref(base, rows.to(torch.int32), values)

    def _register(self, nbytes):
        from repro_torch.runtime import pinned

        raw = np.empty(max(nbytes, 1), np.uint8)
        block = pinned._Block(raw.ctypes.data, nbytes, raw)
        self.blocks[block.addr] = block
        self.registered += 1
        return block

    def _unregister(self, block):
        if self.lock is not None:
            assert not self.lock._is_owned()
        del self.blocks[block.addr]

    def owns(self, arr):
        a = _addr(arr)
        return any(p <= a < p + max(b.nbytes, 1)
                   for p, b in self.blocks.items())


def _addr(arr):
    return arr.__array_interface__["data"][0]


@pytest.mark.parametrize("locked", [True, False])
@pytest.mark.parametrize("case", ["sorted_unique", "contiguous",
                                  "unsorted_unique", "single"])
def test_dispatch_routes_by_page_locked_buffer_and_rows(case, locked, rng,
                                                        monkeypatch):
    """A non-contiguous pair with a page-locked buffer and values on the
    card goes to the in-place op (queued: True), with a pageable buffer to
    the round trip; a contiguous run (and one row) to the host slice-add.
    The counters add one per pair on the path taken, and the in-place path
    counts each touched row's bytes once each way."""
    fake = _FakeLocked(monkeypatch)
    rows = _row_cases(rng)[case]
    D = 12
    base = rng.standard_normal((100, D), dtype=np.float32)
    values = rng.standard_normal((rows.size, D), dtype=np.float32)
    buf = base.copy()
    if locked:
        fake.locked.add(_addr(buf))
    c = Counters()
    kd = KernelDispatch("kernel", c, device="cpu")
    queued = kd.scatter_add_rows(buf, rows, values, None,
                                 torch.from_numpy(values))
    want = base.copy()
    jax_scatter_rows_ref(want, rows, values)
    np.testing.assert_array_equal(buf, want)
    in_place = locked and case in ("sorted_unique", "unsorted_unique")
    round_trip = not locked and case in ("sorted_unique", "unsorted_unique")
    assert queued == in_place
    assert len(fake.calls) == int(in_place)
    assert c.scatter_inplace_pairs == int(in_place)
    assert c.scatter_copy_pairs == int(round_trip)
    # the round trip on the CPU crosses no link
    assert c.scatter_link_bytes == (2 * rows.size * D * 4 if in_place else 0)
    if in_place:
        addr, dev_rows, dev_vals = fake.calls[0]
        assert addr == _addr(buf)
        assert dev_rows.dtype == torch.int32
        assert np.all(np.diff(dev_rows.numpy()) > 0)   # sorted for the kernel
        order = np.argsort(rows, kind="stable")
        assert torch.equal(dev_vals, torch.from_numpy(values[order]))


def test_dispatch_in_place_counts_distinct_rows_and_takes_given_rows(
        rng, monkeypatch):
    """Sorted rows with duplicates: link bytes count the distinct rows; the
    rows given on the card are passed through as they are."""
    fake = _FakeLocked(monkeypatch)
    rows = np.array([2, 2, 5, 9, 9, 9, 40])
    D = 8
    buf = rng.standard_normal((50, D), dtype=np.float32)
    fake.locked.add(_addr(buf))
    values = rng.standard_normal((rows.size, D), dtype=np.float32)
    want = ref.scatter_add_ref_np(buf, rows, values)
    c = Counters()
    dev_rows = torch.from_numpy(rows.astype(np.int32))
    assert KernelDispatch("kernel", c, device="cpu").scatter_add_rows(
        buf, rows, values, dev_rows, torch.from_numpy(values))
    np.testing.assert_array_equal(buf, want)
    assert fake.calls[0][1] is dev_rows
    assert c.scatter_link_bytes == 2 * 4 * D * 4


def _engine_run(cache, depth, monkeypatch, fake=None, epochs=2, on=None):
    """Two GCN epochs of the engine on the CPU at a small size, with the
    write-back's values handed on as if on the card and, with ``fake``, the
    engine's grad buffers from a page-locked pool. ``cache``: ``roomy``
    (everything fits), ``spill`` (a budget of a few grad buffers) or
    ``degraded`` (no grad buffer fits). ``on(eng)`` runs after each epoch.
    Returns ``(results, seen, counters, pool, engine)``."""
    from repro_torch.core.cache import HostCache
    from repro_torch.core.engine import SSOEngine
    from repro_torch.core.storage import StorageTier
    from repro_torch.graph.synthetic import random_features, random_labels
    from repro_torch.launch.infer import _smoke_graph
    from repro_torch.models.gnn.layers import get_gnn
    from repro_torch.runtime import PipelineConfig
    from repro_torch.runtime.pinned import PageLockedPool

    dims = [16, 24, 24, 6]
    g, plan = _smoke_graph(900, 6, 4, "cpu")
    spec = get_gnn("gcn")
    X = random_features(g.n_nodes, dims[0], 0)[plan.ro.perm]
    Y = random_labels(g.n_nodes, dims[-1], 0)[plan.ro.perm]
    budget = {"roomy": 64 << 20, "spill": 96 << 10,
              "degraded": 1 << 10}[cache]
    c = Counters()
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    hc = HostCache(budget, st, c)
    eng = SSOEngine(spec, plan, dims, st, hc, c,
                    pipeline=PipelineConfig(depth=depth, kernels="kernel"),
                    device="cpu")
    seen = {"add": [], "write": []}
    if fake is not None:
        fake.lock = hc._lock
        eng._grad_bufs = PageLockedPool(hc, pin=True)
        acc, write = eng.kernels.scatter_add_rows, eng._rt.write_rows

        def spy_add(buf, rows, values, dev_rows=None, dev_values=None):
            seen["add"].append(fake.owns(buf))
            if dev_values is None:
                dev_values = torch.from_numpy(values)
            return acc(buf, rows, values, dev_rows, dev_values)

        def spy_write(name, row0, arr):
            if name.startswith("grad"):
                seen["write"].append(fake.owns(arr))
            return write(name, row0, arr)

        monkeypatch.setattr(eng.kernels, "scatter_add_rows", spy_add)
        monkeypatch.setattr(eng._rt, "write_rows", spy_write)
    params = spec.init(torch.Generator().manual_seed(0), dims[0],
                       dims[1], dims[-1], len(dims) - 1, device="cpu")
    out = []
    pool = eng._grad_bufs
    try:
        eng.initialize(X)
        for _ in range(epochs):
            out.append(eng.run_epoch(params, Y))
            if on is not None:
                on(eng)
    finally:
        eng.close()
        st.close()
    return out, seen, c, pool, eng


def _same_grads(plain, mine):
    for (la, ga), (lb, gb) in zip(plain, mine):
        assert la == lb
        for a, b in zip(ga, gb):
            for k in a:
                assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("cache", ["roomy", "degraded"])
@pytest.mark.parametrize("depth", [0, 2])
def test_grad_accumulate_takes_page_locked_buffers(cache, depth, monkeypatch):
    """Every host grad buffer ``_grad_accumulate`` creates — the zeroed
    first one and the one read back after a spill, in the cache and in
    degraded mode — comes from the engine's page-locked pool, and every
    pair's add lands in one. With the values handed on as if on the card,
    the non-contiguous pairs take the in-place path (its release and its
    degraded write deferred to the unit's end) and the gradients equal the
    round trip's bitwise. Roomy, the blocks of the first epoch serve the
    second; degraded, no block outlives its unit's write."""
    plain, _, c0, _, _ = _engine_run(cache, depth, monkeypatch)
    assert c0.scatter_copy_pairs > 0 and c0.scatter_inplace_pairs == 0
    fake = _FakeLocked(monkeypatch)
    registered = []
    mine, seen, c, pool, _ = _engine_run(
        cache, depth, monkeypatch, fake,
        on=lambda eng: registered.append(fake.registered))
    assert seen["add"] and all(seen["add"])
    assert c.scatter_inplace_pairs == c0.scatter_copy_pairs
    assert c.scatter_copy_pairs == 0
    assert len(fake.calls) == c.scatter_inplace_pairs
    if cache == "degraded":
        assert seen["write"] and all(seen["write"])
        assert registered[1] > registered[0] > 0
    else:
        assert not seen["write"]
        assert registered[1] == registered[0] > 0   # nothing new in epoch 2
    _same_grads(plain, mine)
    gc.collect()
    assert pool.bytes == 0 and not fake.blocks       # all freed at close


@pytest.mark.parametrize("cache", ["spill", "degraded", "roomy"])
@pytest.mark.parametrize("depth", [0, 2])
def test_page_locked_pool_stays_inside_the_cache_budget(cache, depth,
                                                        monkeypatch):
    """The cache's bytes (its entries, reservations and the pool's parked
    blocks) never pass the budget, the parked blocks are among them, and
    after each epoch every registered block is a parked one: no page-locked
    memory outside the budget at rest. Degraded, nothing is parked; in the
    spill case the cache takes parked blocks back (unregistered with its
    lock free) rather than evict, and the gradients are the pageable
    run's."""
    plain, _, _, _, _ = _engine_run(cache, depth, monkeypatch)
    fake = _FakeLocked(monkeypatch)
    samples, at_rest, reclaimed = [], [], []

    def on(eng):
        pool, hc = eng._grad_bufs, eng.cache
        at_rest.append((pool.bytes, pool.parked_bytes, hc.used_bytes))

    from repro_torch.runtime import pinned

    real_settle, real_reclaim = (pinned.PageLockedPool.settle,
                                 pinned.PageLockedPool.reclaim)

    def settle(pool):
        real_settle(pool)
        samples.append((pool.parked_bytes, pool.cache.used_bytes,
                        pool.cache.budget))

    def reclaim(pool, need):
        out = real_reclaim(pool, need)
        reclaimed.extend(out)
        return out

    monkeypatch.setattr(pinned.PageLockedPool, "settle", settle)
    monkeypatch.setattr(pinned.PageLockedPool, "reclaim", reclaim)
    mine, _, c, pool, eng = _engine_run(cache, depth, monkeypatch, fake,
                                        epochs=3, on=on)
    _same_grads(plain, mine)
    assert samples
    assert all(parked <= used <= budget for parked, used, budget in samples)
    assert eng.cache.peak_bytes <= eng.cache.budget
    assert all(b == parked <= used for b, parked, used in at_rest)
    if cache == "degraded":
        assert all(b == 0 for b, _, _ in at_rest)
    else:
        assert any(parked > 0 for _, parked, _ in at_rest)
    if cache == "spill":
        assert c.cache_evictions > 0 and reclaimed
    gc.collect()
    assert pool.bytes == 0 and not fake.blocks


def test_cache_reclaims_parked_blocks_before_it_evicts(monkeypatch):
    """A parked block is a reservation the cache takes back first: an entry
    that fits once the block is gone stays resident, the block is
    unregistered outside the cache's lock, and a block taken for reuse
    brings its reservation to the caller."""
    from repro_torch.core.cache import HostCache
    from repro_torch.core.storage import StorageTier
    from repro_torch.runtime.pinned import PageLockedPool

    c = Counters()
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    hc = HostCache(10_000, st, c)
    fake = _FakeLocked(monkeypatch, lock=hc._lock)
    pool = PageLockedPool(hc, pin=True)
    assert hc.reserve(4000)
    a = pool.new((1000,), np.float32)
    assert hc.put(("grad", 1, 0), a, dirty=True, reserved_bytes=4000)
    hc.drop(("grad", 1, 0), flush=False)
    del a
    pool.settle()
    assert pool.parked_bytes == 4000 == hc.used_bytes == pool.bytes
    b = pool.take((500, 2), np.float32)             # same bytes: reused
    assert b is not None and fake.registered == 1
    assert pool.parked_bytes == 0 and hc.used_bytes == 4000
    assert hc.put(("grad", 1, 1), b, dirty=True, reserved_bytes=4000)
    hc.drop(("grad", 1, 1), flush=False)
    del b
    pool.settle()
    assert hc.put(("act", 0, 0), np.zeros(1000, np.float32))
    assert hc.used_bytes == 8000 and pool.parked_bytes == 4000
    assert hc.reserve(5000)                         # the block goes first
    assert hc.contains(("act", 0, 0)) and c.cache_evictions == 0
    assert pool.parked_bytes == 0 and pool.bytes == 0 and not fake.blocks
    assert hc.used_bytes == 9000
    pool.close()
    st.close()
