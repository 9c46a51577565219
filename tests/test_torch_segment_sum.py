"""``segment_sum`` (``kernels/gather_scatter``): the card's route of the
layers' ``seg_sum``, and its plain version.

On the CPU (every machine): the plain version
(``ref.segment_sum_ref``, which ``ops.segment_sum`` runs on CPU tensors)
is bitwise a sequential ``np.add.at`` where no segment has more than
``SEGMENT_CHUNK`` edges, and bitwise a numpy sum in chunk order where
segments do (a 70,000-edge tail into row 0, as a plan's padding gives,
and the benchmark graph's own plan at a narrow width); empty segments
are zeros, ids outside ``[0, n)`` fall in no segment, the backward is a
row gather.

Marked ``cuda`` (skip without a device: the kernel has no CPU mode), on
every unit of the benchmark graph's plan (``perfbench/rmat.py`` at
structure seed 0, 16 switching-aware partitions, ``build_plan`` with its
power-of-two padding) with ``dst`` and ``src`` ids at widths 1, 4, 19,
256 and 1,024: the kernel equals its plain version bitwise and itself on
a rerun; segments of at most ``SEGMENT_CHUNK`` edges equal
``index_put_(accumulate=True)`` bitwise at widths of 32 and more; the
backward equals ``index_select``; bad inputs raise; one GCN and one
GCNII step through ``SSOEngine`` launch ``segment_sum`` and no
``indexing_backward_kernel``, and match the same step whose sums take the
CPU's ``index_add_`` route. This file imports nothing of JAX::

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_segment_sum.py
"""
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.kernels.gather_scatter import ops, ref
from repro_torch.models.gnn import layers as tl

K = ops.SEGMENT_CHUNK
WIDTHS = (1, 4, 19, 256, 1024)


def add_at(x, seg, n):
    """Sequential ``np.add.at`` in edge order, float32."""
    out = np.zeros((n,) + x.shape[1:], np.float32)
    keep = (seg >= 0) & (seg < n)
    np.add.at(out, seg[keep], x[keep])
    return out


def chunk_order_loop(x, seg, n, chunk):
    """The chunk order, one float32 add at a time: each segment's edges in
    edge order, cut into chunks of ``chunk`` from its start; each chunk
    summed from zero, the chunk sums added from zero in order."""
    out = np.zeros((n,) + x.shape[1:], np.float32)
    for r in range(n):
        idx = np.flatnonzero(seg == r)
        acc = np.zeros(x.shape[1:], np.float32)
        for c0 in range(0, idx.size, chunk):
            part = np.zeros(x.shape[1:], np.float32)
            for i in idx[c0:c0 + chunk]:
                part = part + x[i]
            acc = acc + part
        out[r] = acc
    return out


def chunk_order_np(x, seg, n, chunk):
    """The same order, vectorised: chunk sums by ``np.add.at`` over the
    stably sorted edges, then segment sums of the chunks in order."""
    order = np.argsort(seg, kind="stable")
    keys = seg[order]
    keep = (keys >= 0) & (keys < n)
    order, keys = order[keep], keys[keep]
    pos = np.arange(keys.size) - np.searchsorted(keys, keys, "left")
    opens = pos % chunk == 0
    chunks = np.zeros((int(opens.sum()),) + x.shape[1:], np.float32)
    np.add.at(chunks, np.cumsum(opens) - 1, x[order])
    out = np.zeros((n,) + x.shape[1:], np.float32)
    np.add.at(out, keys[opens], chunks)
    return out


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module")
def bench_plan():
    """The benchmark graph's plan on the CPU: ``perfbench.rmat`` at
    structure seed 0 (65,536 nodes, 12 draws a node), 16 switching-aware
    partitions, ``build_plan`` with GCN weights and power-of-two padding
    (the padded edges point at row 0 on both ends)."""
    from perfbench.rmat import rmat_graph
    from repro_torch.core.plan import build_plan
    from repro_torch.graph.csr import CSRGraph, gcn_norm_coeffs
    from repro_torch.graph.partition import switching_aware_partition

    indptr, indices = rmat_graph(65536, 12, 0, 0.57, 0.19, 0.19)
    g = CSRGraph(indptr=indptr, indices=indices, n_nodes=65536)
    parts = switching_aware_partition(g, 16, seed=0).parts
    return build_plan(g, parts, 16, edge_weight=gcn_norm_coeffs(g),
                      device="cpu")


def unit_keys(u, key):
    """``(ids, n)`` of a unit's segment sum over ``dst`` (the forward's
    aggregate) or ``src`` (the edge gather's backward)."""
    t = u.topo
    if key == "dst":
        return t.dst, t.n_dst
    return t.src, u.n_req


# ------------------------------------------------------------------ the CPU
@pytest.mark.parametrize("shape", [(), (1,), (4,), (19,), (2, 3), (40,),
                                   (256,)])
def test_plain_equals_add_at_without_long_segments(shape):
    rng = np.random.default_rng(len(shape) * 31 + sum(shape))
    E, n = 3000, 257
    x = rng.standard_normal((E,) + shape).astype(np.float32)
    seg = rng.integers(0, n, E).astype(np.int32)       # any order
    seg[:5] = 3                                         # one longer run
    got = ops.segment_sum(*_t(x, seg), n)
    assert got.shape == (n,) + shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), add_at(x, seg, n))
    # the layers' CPU route is the same sequential sum
    np.testing.assert_array_equal(tl.seg_sum(*_t(x, seg), n).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("width,hub", [(1, 70000), (3, 70000), (5, 2 * K),
                                       (2, K + 1), (4, K), (7, 3 * K - 1)])
def test_plain_sums_long_segments_in_chunk_order(width, hub):
    """A padded tail of ``hub`` edges into row 0 spread among other edges,
    as a plan's padding gives, beside a second long segment."""
    rng = np.random.default_rng(hub + width)
    n, E = 40, 3000
    seg = np.concatenate([rng.integers(0, n, E), np.zeros(hub, np.int64),
                          np.full(K + 7, n - 1)]).astype(np.int32)
    rng.shuffle(seg[:E + hub // 2])
    x = (rng.standard_normal((seg.size, width)) * 10 ** rng.uniform(
        -3, 3, (seg.size, 1))).astype(np.float32)
    got = ops.segment_sum(*_t(x, seg), n).numpy()
    np.testing.assert_array_equal(got, chunk_order_loop(x, seg, n, K))
    np.testing.assert_array_equal(got, chunk_order_np(x, seg, n, K))
    counts = np.bincount(seg, minlength=n)
    short = counts <= K
    np.testing.assert_array_equal(got[short], add_at(x, seg, n)[short])
    if hub >= 2 * K:  # the chunk order is not edge order on the long rows
        assert not np.array_equal(got[0], add_at(x, seg, n)[0])


def test_plain_empty_segments_and_ids_outside_are_dropped():
    x = np.arange(1, 13, dtype=np.float32).reshape(6, 2)
    seg = np.array([4, -1, 1, 6, 4, 1], np.int32)
    got = ops.segment_sum(*_t(x, seg), 5).numpy()
    want = np.zeros((5, 2), np.float32)
    want[1] = x[2] + x[5]
    want[4] = x[0] + x[4]
    np.testing.assert_array_equal(got, want)
    assert not np.signbit(got).any()               # +0, never -0
    neg = ops.segment_sum(torch.tensor([-0.0, -0.0]),
                          torch.tensor([1, 1], dtype=torch.int32), 2)
    assert not torch.signbit(neg).any()


@pytest.mark.parametrize("E,n,shape", [(0, 5, (3,)), (4, 0, (3,)),
                                       (4, 3, (0,)), (0, 0, ())])
def test_plain_degenerate_shapes_are_zeros(E, n, shape):
    got = ops.segment_sum(torch.ones((E,) + shape),
                          torch.zeros(E, dtype=torch.int32), n)
    assert got.shape == (n,) + shape
    assert not got.any()


def test_plain_backward_is_a_row_gather():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((900, 6)).astype(np.float32))
    seg = torch.from_numpy(np.concatenate([
        rng.integers(0, 50, 200), np.zeros(700, np.int64)]).astype(np.int32))
    x.requires_grad_(True)
    out = ops.segment_sum(x, seg, 50)
    g = torch.from_numpy(rng.standard_normal((50, 6)).astype(np.float32))
    (gx,) = torch.autograd.grad(out, x, g)
    assert torch.equal(gx, g.index_select(0, seg))


def test_wrapper_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="seg"):
        ops.segment_sum(torch.ones(4, 2), torch.zeros(3, dtype=torch.int32),
                        2)
    with pytest.raises(ValueError):
        ops.segment_sum(torch.ones(4, 2), torch.zeros((4, 1),
                                                      dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="n must be"):
        ops.segment_sum(torch.ones(4, 2), torch.zeros(4, dtype=torch.int32),
                        -1)


@pytest.mark.parametrize("key", ["dst", "src"])
def test_plain_on_the_benchmark_plan_is_the_chunk_order(bench_plan, key):
    """Every unit of the benchmark's plan at width 2: segments up to
    ``SEGMENT_CHUNK`` edges in edge order, longer ones (row 0's padded tail,
    the hubs) in chunk order."""
    rng = np.random.default_rng(0)
    long_rows = 0
    for u in bench_plan.units:
        ids, n = unit_keys(u, key)
        ids = ids.numpy()
        x = rng.standard_normal((ids.size, 2)).astype(np.float32)
        got = ops.segment_sum(*_t(x, ids), n).numpy()
        np.testing.assert_array_equal(got, chunk_order_np(x, ids, n, K))
        short = np.bincount(ids, minlength=n) <= K
        np.testing.assert_array_equal(got[short], add_at(x, ids, n)[short])
        long_rows += int((~short).sum())
    assert long_rows >= 16           # at least each unit's padded row 0


# ----------------------------------------------------------------- the card
@pytest.fixture()
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("key", ["dst", "src"])
def test_cuda_segment_sum_on_every_unit_of_the_benchmark_plan(
        cuda_dev, bench_plan, key, width):
    gen = torch.Generator(device=cuda_dev).manual_seed(width)
    for u in bench_plan.units:
        ids, n = unit_keys(u, key)
        ids = ids.to(cuda_dev)
        x = torch.randn((ids.shape[0], width), generator=gen,
                        device=cuda_dev)
        before = ops.LAUNCHES["segment_sum"]
        got = ops.segment_sum(x, ids, n)
        assert ops.LAUNCHES["segment_sum"] == before + 1
        want = ref.segment_sum_ref(x, ids, n, K)
        assert torch.equal(got, want), (u.p, key, width)
        assert torch.equal(ops.segment_sum(x, ids, n), got), "rerun"
        if width <= 19:        # the plain version is the same on the CPU
            assert torch.equal(
                ref.segment_sum_ref(x.cpu(), ids.cpu(), n, K), got.cpu())
        if width >= 32:
            lib = x.new_zeros((n, width)).index_put_(
                (ids.long(),), x, accumulate=True)
            short = torch.bincount(ids.long(), minlength=n) <= K
            assert torch.equal(got[short], lib[short]), (u.p, key, width)
        del x, got, want


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(), (3,), (4,), (2, 8), (130,)])
def test_cuda_segment_sum_trailing_shapes_and_empty_segments(cuda_dev, shape):
    rng = np.random.default_rng(7)
    n, E = 600, 5000
    seg = np.concatenate([rng.integers(0, n // 2, E),
                          np.zeros(3 * K + 5, np.int64)]).astype(np.int32)
    rng.shuffle(seg)
    x = rng.standard_normal((seg.size,) + shape).astype(np.float32)
    got = ops.segment_sum(*(t.to(cuda_dev) for t in _t(x, seg)), n)
    assert got.shape == (n,) + shape
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  chunk_order_np(x, seg, n, K))
    assert not got[n // 2:].any()                     # empty segments


@pytest.mark.cuda
def test_cuda_segment_sum_unaligned_view_and_ids_outside(cuda_dev):
    """A base 4 bytes past 16-byte alignment takes the one-float path, with
    the same bits; ids outside ``[0, n)`` fall in no segment."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal(
        (2001 * 8 + 1,)).astype(np.float32)).to(cuda_dev)
    view = x[1:].view(2001, 8)
    seg = torch.from_numpy(rng.integers(-3, 70, 2001).astype(
        np.int32)).to(cuda_dev)
    got = ops.segment_sum(view, seg, 64)
    want = chunk_order_np(view.cpu().numpy(), seg.cpu().numpy(), 64, K)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_cuda_segment_sum_backward_is_index_select(cuda_dev):
    rng = np.random.default_rng(9)
    seg = torch.from_numpy(np.concatenate([
        rng.integers(0, 300, 4000), np.zeros(2000, np.int64)]).astype(
            np.int32)).to(cuda_dev)
    x = torch.randn((6000, 64), device=cuda_dev, requires_grad=True)
    g = torch.randn((300, 64), device=cuda_dev)
    (gx,) = torch.autograd.grad(ops.segment_sum(x, seg, 300), x, g)
    assert torch.equal(gx, g.index_select(0, seg))
    # the layers' route on the card is the kernel
    before = ops.LAUNCHES["segment_sum"]
    out = tl.seg_sum(x, seg, 300)
    assert ops.LAUNCHES["segment_sum"] == before + 1
    assert torch.equal(out, ops.segment_sum(x, seg, 300))


@pytest.mark.cuda
def test_cuda_segment_sum_refuses_bad_inputs(cuda_dev):
    seg = torch.zeros(8, dtype=torch.int32, device=cuda_dev)
    x = torch.ones((8, 4), device=cuda_dev)
    with pytest.raises(TypeError):
        ops.segment_sum(x.double(), seg, 2)
    with pytest.raises(TypeError):
        ops.segment_sum(x, seg.long(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.segment_sum(torch.ones((4, 8), device=cuda_dev).t(), seg, 2)
    with pytest.raises(ValueError, match="is on"):
        ops.segment_sum(x, seg.cpu(), 2)
    with pytest.raises(ValueError, match="is on"):
        ops.segment_sum(x.cpu(), seg, 2)


def _engine_step(family, dims, dev):
    """One ``SSOEngine`` epoch (serial, ``kernel`` dispatch) of ``family``
    on a 300-node graph with a cache that spills, on ``dev``."""
    from repro_torch.core.cache import HostCache
    from repro_torch.core.counters import Counters
    from repro_torch.core.engine import SSOEngine
    from repro_torch.core.plan import build_plan
    from repro_torch.core.storage import StorageTier
    from repro_torch.graph.csr import add_self_loops, gcn_norm_coeffs
    from repro_torch.graph.partition import switching_aware_partition
    from repro_torch.graph.synthetic import (
        kronecker_graph, random_features, random_labels,
    )
    from repro_torch.runtime import PipelineConfig

    g = add_self_loops(kronecker_graph(300, 6, seed=0))
    parts = switching_aware_partition(g, 4, max_iters=8, seed=0).parts
    plan = build_plan(g, parts, 4, edge_weight=gcn_norm_coeffs(g),
                      device=dev)
    x = random_features(g.n_nodes, dims[0], 0)
    y = random_labels(g.n_nodes, dims[-1], 0)
    spec = tl.get_gnn(family)
    params = spec.init(torch.Generator().manual_seed(0), dims[0], dims[1],
                       dims[-1], len(dims) - 1, device=dev)
    c = Counters()
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    eng = SSOEngine(spec, plan, dims, st, HostCache(1 << 16, st, c), c,
                    device=dev,
                    pipeline=PipelineConfig(depth=0, kernels="kernel"))
    eng.initialize(x[plan.ro.perm])
    try:
        loss, grads = eng.run_epoch(params, y[plan.ro.perm])
        torch.cuda.synchronize(dev)
    finally:
        eng.close()
        st.close()
    return loss, grads


@pytest.mark.cuda
@pytest.mark.parametrize("family,dims", [
    ("gcn", [24, 32, 32, 8]), ("gcnii", [24] + [16] * 5 + [5]),
])
def test_cuda_engine_step_launches_segment_sum_only(cuda_dev, family, dims):
    from torch.profiler import ProfilerActivity, profile

    _engine_step(family, dims, cuda_dev)            # build and warm up
    before = ops.LAUNCHES["segment_sum"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        loss, _ = _engine_step(family, dims, cuda_dev)
    assert np.isfinite(loss)
    names = {e.key for e in prof.key_averages()}
    assert any("segment_sum" in k for k in names), sorted(names)
    assert not any("indexing_backward_kernel" in k for k in names), \
        sorted(names)
    assert ops.LAUNCHES["segment_sum"] > before


@pytest.mark.cuda
@pytest.mark.parametrize("family,dims", [
    ("gcn", [24, 32, 32, 8]), ("gcnii", [24] + [16] * 5 + [5]),
])
def test_cuda_engine_step_matches_sums_by_the_cpu_route(
        cuda_dev, monkeypatch, family, dims):
    """The same step with every segment sum taken by the CPU's
    ``index_add_`` (edge order throughout) and the rest on the card: the
    kernel == reference checks on the card run the kernel on both sides,
    so this holds the kernel against a path without it. The plan's padded
    rows and hubs have more than ``SEGMENT_CHUNK`` edges, where the chunk
    order rounds differently: the loss within 1e-6 relative, each
    gradient within 1e-5 of its largest magnitude."""
    loss, grads = _engine_step(family, dims, cuda_dev)
    cpu_sum = tl.seg_sum

    def by_the_cpu(x, seg, n):
        assert x.is_cuda
        return cpu_sum(x.cpu(), seg.cpu(), n).to(x.device)

    monkeypatch.setattr(tl, "seg_sum", by_the_cpu)
    before = ops.LAUNCHES["segment_sum"]
    want_loss, want = _engine_step(family, dims, cuda_dev)
    assert ops.LAUNCHES["segment_sum"] == before     # no kernel on this side
    assert abs(loss - want_loss) <= 1e-6 * abs(want_loss), (loss, want_loss)
    for got, ref_g in zip(grads, want):
        assert got.keys() == ref_g.keys()
        for k in got:
            scale = float(ref_g[k].abs().max())
            err = float((got[k] - ref_g[k]).abs().max())
            assert err <= 1e-5 * scale, (k, err, scale)
