"""The CUDA kernels (gather/scatter, edge softmax, embedding bag, flash
attention, block-sparse SpMM) on the card, against the numpy oracles and their plain versions.

Marked ``cuda``: they skip where there is no CUDA device (the kernels have
no CPU mode; the CPU tests cover the plain versions). This file imports
nothing of JAX, so it also runs on a machine without it::

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.bsr_spmm import ops as bs_ops
from repro_torch.kernels.bsr_spmm import ref as bs_ref
from repro_torch.kernels.edge_softmax import ops as es_ops
from repro_torch.kernels.edge_softmax import ref as es_ref
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag import ref as eb_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.core.counters import Counters
from repro_torch.kernels.dispatch import KernelDispatch, scatter_add_rows_ref
from repro_torch.kernels.gather_scatter import ops, ref
from repro_torch.runtime.pinned import PageLockedPool, page_locked_empty


@pytest.fixture()
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def _agg_inputs(rng, n, E, nd, D):
    table = rng.standard_normal((n, D), dtype=np.float32)
    erows = rng.integers(0, n, E).astype(np.int32)
    dst = np.sort(rng.integers(0, nd, E)).astype(np.int32)
    w = rng.standard_normal(E, dtype=np.float32)
    return table, erows, dst, w


def _on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,D", [(300, 77, 48), (9, 1, 201), (257, 511, 1024)])
def test_cuda_gather_rows_bitwise(cuda_dev, n, r, D, rng):
    table = rng.standard_normal((n, D), dtype=np.float32)
    rows = rng.integers(0, n, r).astype(np.int32)
    before = ops.LAUNCHES["gather_rows"]
    got = ops.gather_rows(*_on(cuda_dev, table, rows))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), table[rows])
    assert ops.LAUNCHES["gather_rows"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,E,nd,D", [
    (64, 400, 32, 16), (10, 30, 5, 129), (6, 1, 3, 8), (128, 2000, 40, 256),
])
def test_cuda_gather_aggregate_bitwise_vs_fma_oracle(cuda_dev, n, E, nd, D,
                                                    rng):
    table, erows, dst, w = _agg_inputs(rng, n, E, nd, D)
    got = ops.gather_aggregate(
        *_on(cuda_dev, table, erows, dst, w), nd)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        got.cpu().numpy(), ref.gather_aggregate_ref_fma(table, erows, dst, w, nd))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_inputs(cuda_dev):
    t = torch.zeros(4, 4, device=cuda_dev)
    with pytest.raises(TypeError):
        ops.gather_rows(t, torch.zeros(2, dtype=torch.int64, device=cuda_dev))
    with pytest.raises(ValueError, match="expected"):
        ops.gather_rows(t, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ops.gather_rows(t.t(), torch.zeros(2, dtype=torch.int32,
                                           device=cuda_dev))


@pytest.mark.cuda
def test_cuda_gather_aggregate_rows_without_edges_are_zero(cuda_dev):
    table = torch.randn(10, 16, device=cuda_dev)
    erows = torch.tensor([1, 2, 3], dtype=torch.int32, device=cuda_dev)
    dst = torch.tensor([2, 2, 5], dtype=torch.int32, device=cuda_dev)
    w = torch.ones(3, device=cuda_dev)
    out = ops.gather_aggregate(table, erows, dst, w, 7)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out[[0, 1, 3, 4, 6]]) == 0


def _heavy_agg_inputs(rng, n, nd, D, hubs, E=2000):
    """``_agg_inputs`` plus, for each ``(row, k)`` in ``hubs``, ``k`` more
    edges into ``row`` (power-law hub rows above the split threshold)."""
    table, erows, dst, w = _agg_inputs(rng, n, E, nd, D)
    extra = sum(k for _, k in hubs)
    dst = np.sort(np.concatenate(
        [dst, *(np.full(k, r, np.int32) for r, k in hubs)])).astype(np.int32)
    erows = np.concatenate([erows, rng.integers(0, n, extra).astype(np.int32)])
    w = np.concatenate([w, rng.standard_normal(extra, dtype=np.float32)])
    return table, erows, dst, w


def _table_at(dev, table, offset):
    """``table`` on the card, its base ``offset`` floats past an aligned one
    (offset 1: not 16-byte aligned, the kernels' scalar path)."""
    flat = torch.empty(table.size + offset, device=dev)
    t = flat[offset:].view(table.shape)
    t.copy_(torch.from_numpy(table))
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("D", [1024, 256, 129])
def test_cuda_gather_aggregate_heavy_rows_bitwise_vs_fma_oracle(cuda_dev, D,
                                                               offset, rng):
    """One 30,000-edge hub and one 600-edge row (both above the split
    threshold) among ordinary rows: bitwise the FMA oracle, and on a rerun,
    at aligned and offset table bases."""
    nd = 50
    table, erows, dst, w = _heavy_agg_inputs(
        rng, 300, nd, D, [(17, 30000), (nd - 1, 600)])
    assert 600 > ops.HEAVY_EDGES
    t = _table_at(cuda_dev, table, offset)
    er, ds, ws = _on(cuda_dev, erows, dst, w)
    before = ops.LAUNCHES["gather_aggregate"]
    got = ops.gather_aggregate(t, er, ds, ws, nd)
    again = ops.gather_aggregate(t, er, ds, ws, nd)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["gather_aggregate"] == before + 2
    assert torch.equal(got, again)
    np.testing.assert_array_equal(
        got.cpu().numpy(), ref.gather_aggregate_ref_fma(table, erows, dst, w, nd))


@pytest.mark.cuda
@pytest.mark.parametrize("n_dst,E,T,hubs", [
    (500, 4000, 16, ()), (300, 2000, 64, ((7, 3000), (250, 90))),
    (64, 64, 0, ()), (40, 0, 3, ()), (3000, 20000, 256, ((0, 5000),)),
    (5000, 30000, 1, ()),
])
def test_cuda_row_plan_equals_its_plain_version(cuda_dev, n_dst, E, T, hubs,
                                                rng):
    """The planner both kernels launch first: row starts and the heavy
    list (huge rows first, row order, -1 after) bitwise its plain
    version."""
    dst = np.sort(np.concatenate(
        [rng.integers(0, n_dst, E), *(np.full(k, r) for r, k in hubs)]
    )).astype(np.int32)
    got = ops.row_plan(torch.from_numpy(dst).to(cuda_dev), n_dst, T)
    want = ops.row_plan(torch.from_numpy(dst), n_dst, T)
    torch.cuda.synchronize()
    for g, wnt in zip(got, want):
        assert torch.equal(g.cpu(), wnt)


@pytest.mark.cuda
def test_cuda_gather_aggregate_rounds_each_edge_once(cuda_dev):
    """Two edges whose float64 sum lands on a float32 tie: the kernel's
    fused multiply-add rounds once (2^70 + 2^47), as the exact oracle does;
    the float64 route rounds twice (2^70 + 2^48)."""
    table = np.array([[1.0], [2.0 ** 23 - 1]], np.float32)
    erows, dst = np.array([0, 1], np.int32), np.zeros(2, np.int32)
    w = np.array([2.0 ** 70 + 2.0 ** 47, 2.0 ** 23 + 1], np.float32)
    got = ops.gather_aggregate(*_on(cuda_dev, table, erows, dst, w), 1)
    want, twice = ref.gather_aggregate_fma_np(table, erows, dst, w, 1)
    assert twice == 1
    assert got.item() == want[0, 0] == np.float32(2.0 ** 70 + 2.0 ** 47)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1024, 36, 129])
def test_cuda_gather_aggregate_many_heavy_rows_bitwise(cuda_dev, D, rng,
                                                       monkeypatch):
    """A threshold of 3 edges makes most rows heavy: more (row, slab) items
    than the persistent grid has blocks, several a block, stages that wrap
    around the ring across items, short last stages."""
    monkeypatch.setattr(ops, "HEAVY_EDGES", 3)
    nd = 300
    table, erows, dst, w = _agg_inputs(rng, 400, 6000, nd, D)
    got = ops.gather_aggregate(*_on(cuda_dev, table, erows, dst, w), nd)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        got.cpu().numpy(), ref.gather_aggregate_ref_fma(table, erows, dst, w, nd))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1024, 129])
def test_cuda_gather_aggregate_rows_without_edges_are_zero_beside_hubs(
        cuda_dev, D, rng):
    nd = 40
    table, erows, dst, w = _heavy_agg_inputs(rng, 100, nd, D, [(3, 5000)],
                                             E=300)
    keep = ~np.isin(dst, [0, 1, 20, nd - 1])
    erows, dst, w = erows[keep], dst[keep], w[keep]
    empty = np.setdiff1d(np.arange(nd), dst)
    assert empty.size >= 4
    out = ops.gather_aggregate(*_on(cuda_dev, table, erows, dst, w), nd)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out[torch.from_numpy(empty).to(cuda_dev)]) == 0
    assert torch.count_nonzero(out[3]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,D", [
    (64, 200, 16), (300, 77, 48), (10, 1, 7), (40, 90, 7), (257, 511, 1024),
])
def test_cuda_scatter_add_bitwise_vs_oracle(cuda_dev, n, r, D, rng):
    base = rng.standard_normal((n, D), dtype=np.float32)
    rows = np.sort(rng.integers(0, n // 2 + 1, r)).astype(np.int32)
    values = rng.standard_normal((r, D), dtype=np.float32)
    before = ops.LAUNCHES["scatter_add"]
    b = torch.from_numpy(base).to(cuda_dev)
    out = ops.scatter_add_(b, *_on(cuda_dev, rows, values))
    torch.cuda.synchronize()
    assert out is b
    # duplicates in input order, and the untouched tail keeps base's bits
    np.testing.assert_array_equal(b.cpu().numpy(),
                                  ref.scatter_add_ref_np(base, rows, values))
    assert ops.LAUNCHES["scatter_add"] == before + 1
    plain = ref.scatter_add_ref(torch.from_numpy(base).to(cuda_dev),
                                *_on(cuda_dev, rows, values))
    assert torch.equal(plain, b)


@pytest.mark.cuda
def test_cuda_scatter_add_refuses_bad_inputs(cuda_dev):
    b = torch.zeros(4, 4, device=cuda_dev)
    rows = torch.zeros(2, dtype=torch.int32, device=cuda_dev)
    with pytest.raises(TypeError):
        ops.scatter_add_(b, rows.long(), torch.zeros(2, 4, device=cuda_dev))
    with pytest.raises(ValueError, match="expected"):
        ops.scatter_add_(b, rows.cpu(), torch.zeros(2, 4, device=cuda_dev))
    with pytest.raises(ValueError, match="contiguous"):
        ops.scatter_add_(b.t(), rows, torch.zeros(2, 4, device=cuda_dev))


def _page_locked_base(base):
    """``base`` copied into page-locked host memory of its own pages (as
    the engine's grad buffers are)."""
    arr = page_locked_empty(base.shape, base.dtype)
    arr[...] = base
    return arr


def _engine_rows(rng, n, r):
    """A write-back pair's rows: sorted, duplicate-free, not one run."""
    return np.sort(rng.choice(n, r, replace=False)).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,D,rows", [
    (4096, 900, 1024, "engine"),   # a GAT write-back pair
    (4096, 900, 256, "engine"),    # a GCN one
    (300, 77, 48, "engine"),
    (257, 511, 1024, "dups"),      # sorted with duplicates
    (40, 90, 7, "dups"),           # D % 4 != 0: the scalar kernel
    (10, 1, 7, "engine"),
])
def test_cuda_scatter_add_host_bitwise_vs_oracle(cuda_dev, n, r, D, rows,
                                                 rng):
    base = rng.standard_normal((n, D), dtype=np.float32)
    idx = (_engine_rows(rng, n, r) if rows == "engine"
           else np.sort(rng.integers(0, n // 2 + 1, r)).astype(np.int32))
    values = rng.standard_normal((r, D), dtype=np.float32)
    buf = _page_locked_base(base)
    assert torch.from_numpy(buf).is_pinned()
    before = ops.LAUNCHES["scatter_add"]
    t = torch.from_numpy(buf)
    assert ops.scatter_add_host_(t, *_on(cuda_dev, idx, values)) is t
    torch.cuda.synchronize()
    assert ops.LAUNCHES["scatter_add"] == before + 1
    want = ref.scatter_add_ref_np(base, idx, values)
    np.testing.assert_array_equal(buf, want)
    if rows == "engine":
        host = base.copy()
        scatter_add_rows_ref(host, idx, values)
        np.testing.assert_array_equal(buf, host)
    del t, buf


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["engine", "unsorted_dups", "contiguous"])
def test_cuda_dispatch_adds_in_place_into_page_locked_buffer(cuda_dev, case,
                                                             rng):
    """Through ``KernelDispatch.scatter_add_rows``: a page-locked buffer
    with values on the card is added in place (queued: the caller waits),
    unsorted rows with duplicates in input order (bitwise ``np.add.at``),
    and a contiguous run on the host; the counters say which."""
    n, D = 500, 64
    base = rng.standard_normal((n, D), dtype=np.float32)
    idx = {"engine": _engine_rows(rng, n, 120),
           "unsorted_dups": rng.integers(0, 40, 200),
           "contiguous": np.arange(30, 90)}[case]
    values = (rng.standard_normal((idx.size, D)) * 1e3).astype(np.float32)
    buf = _page_locked_base(base)
    c = Counters()
    kd = KernelDispatch("kernel", c, device=cuda_dev)
    queued = kd.scatter_add_rows(buf, idx, values, None,
                                 torch.from_numpy(values).to(cuda_dev))
    torch.cuda.synchronize()
    assert queued == (case != "contiguous")
    assert c.scatter_inplace_pairs == int(queued)
    assert c.scatter_copy_pairs == 0
    want = ref.scatter_add_ref_np(base, idx, values)
    if case == "contiguous":
        want = base.copy()
        scatter_add_rows_ref(want, idx, values)
    np.testing.assert_array_equal(buf, want)
    assert c.scatter_link_bytes == (
        2 * np.unique(idx).size * D * 4 if queued else 0)
    del buf


@pytest.mark.cuda
def test_cuda_scatter_add_host_refuses_bad_inputs(cuda_dev):
    rows = torch.zeros(2, dtype=torch.int32, device=cuda_dev)
    vals = torch.zeros(2, 4, device=cuda_dev)
    with pytest.raises(ValueError, match="pageable"):
        ops.scatter_add_host_(torch.zeros(4, 4), rows, vals)
    buf = _page_locked_base(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="host memory"):
        ops.scatter_add_host_(torch.from_numpy(buf), rows.cpu(), vals.cpu())
    with pytest.raises(ValueError, match="host memory"):
        ops.scatter_add_host_(torch.zeros(4, 4, device=cuda_dev), rows, vals)
    with pytest.raises(TypeError):
        ops.scatter_add_host_(torch.from_numpy(buf), rows.long(), vals)
    del buf


@pytest.mark.cuda
def test_cuda_page_locked_pool_reuses_exact_blocks_inside_the_budget(
        cuda_dev, tmp_path):
    """Blocks of their exact size (no power of two), page-locked; a block
    whose array and views went is parked inside the cache's budget, served
    again to a request of the same bytes, and taken back (unregistered)
    when the cache needs its room."""
    from repro_torch.core.cache import HostCache
    from repro_torch.core.storage import StorageTier

    c = Counters()
    st = StorageTier(str(tmp_path), counters=c)
    nb = 1000 * 257 * 4
    hc = HostCache(3 * nb, st, c)
    pool = PageLockedPool(hc, pin=True)
    assert hc.reserve(nb)
    a = pool.new((1000, 257), np.float32)
    a.fill(0)
    assert torch.from_numpy(a).is_pinned()
    assert pool.bytes == a.nbytes == nb
    addr = a.__array_interface__["data"][0]
    view = a[10:20]
    assert hc.put(("grad", 1, 0), a, dirty=True, reserved_bytes=nb)
    hc.drop(("grad", 1, 0), flush=False)
    del a
    pool.settle()
    assert pool.parked_bytes == 0                 # the view keeps the block
    del view
    pool.settle()
    assert pool.parked_bytes == nb == hc.used_bytes
    b = pool.take((257, 1000), np.float32)        # same bytes: a's block
    assert b.__array_interface__["data"][0] == addr
    assert torch.from_numpy(b).is_pinned()
    assert pool.parked_bytes == 0 and hc.used_bytes == nb
    hc.unreserve(nb)
    del b
    pool.settle()
    assert pool.parked_bytes == nb
    assert hc.reserve(3 * nb)                     # takes the parked block
    assert pool.bytes == pool.parked_bytes == 0
    assert pool.peak_bytes == nb
    hc.unreserve(3 * nb)
    pool.close()
    st.close()


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["gat", "gcn"])
def test_cuda_epoch_in_place_write_back_equals_round_trip(cuda_dev, model,
                                                          monkeypatch):
    """A whole epoch (serial and pipelined) with the write-back added in
    place in page-locked buffers gives the gradients of the round trip
    through device copies of the buffers, bitwise; a 1 MB cache makes some
    buffers spill and be read back."""
    from repro_torch.kernels import dispatch
    from repro_torch.launch.train import _train_smoke

    def run():
        ops.reset_launches()
        out = _train_smoke(model, 2, kernels="kernel", dense_check=False,
                           n_nodes=3000, cache_mb=1, dims=[24, 64, 64, 8],
                           device=cuda_dev)
        return out, dict(ops.LAUNCHES)

    inplace, n_in = run()
    monkeypatch.setattr(dispatch, "_page_locked", lambda buf: False)
    copy, n_copy = run()
    assert inplace["pipeline_matches_serial"] and copy["pipeline_matches_serial"]
    assert inplace["loss"] == copy["loss"]
    for d in inplace["runs"]:
        a, b = inplace["runs"][d], copy["runs"][d]
        assert a["counters"].scatter_inplace_pairs > 0
        assert a["counters"].scatter_copy_pairs == 0
        assert b["counters"].scatter_copy_pairs == \
            a["counters"].scatter_inplace_pairs
        assert b["counters"].scatter_inplace_pairs == 0
        assert a["losses"] == b["losses"]
        for ga, gb in zip(a["grads"], b["grads"]):
            for la, lb in zip(ga, gb):
                for k in la:
                    assert torch.equal(la[k], lb[k]), k
    assert n_in["scatter_add"] == n_copy["scatter_add"] > 0


def _softmax_inputs(rng, n, E, H, hub=0):
    """Sorted dst into ``n`` rows with rows 0, 1 and a middle row empty, and
    ``hub`` extra edges into one row (a power-law hub)."""
    dst = rng.integers(2, n, E)
    dst = dst[dst != n // 2]
    dst = np.sort(np.concatenate([dst, np.full(hub, n - 3)])).astype(np.int32)
    scores = rng.standard_normal((dst.size, H), dtype=np.float32)
    return scores, dst


@pytest.mark.cuda
@pytest.mark.parametrize("n,E,H,hub", [
    (200, 1500, 1, 0), (300, 2500, 4, 0), (128, 600, 8, 0),
    (1000, 20000, 4, 9000), (5, 3, 2, 0),
])
def test_cuda_edge_softmax_within_bound_of_oracle(cuda_dev, n, E, H, hub,
                                                  rng):
    """Per element within ``(deg + 4 + |s - m|) * 2^-23`` relative of the
    float64 oracle: ``deg`` roundings in the row's sum, two ulp of
    ``expf``, the divide; the float32 ``s - m`` rounds by ``|s - m| * 2^-24``
    absolute, which ``exp`` turns into that much relative error. Bitwise on
    a rerun."""
    scores, dst = _softmax_inputs(rng, n, E, H, hub)
    before = es_ops.LAUNCHES["edge_softmax"]
    s_d, d_d = _on(cuda_dev, scores, dst)
    got = es_ops.edge_softmax(s_d, d_d, n)
    again = es_ops.edge_softmax(s_d, d_d, n)
    torch.cuda.synchronize()
    assert es_ops.LAUNCHES["edge_softmax"] == before + 2
    assert torch.equal(got, again)
    want = es_ref.edge_softmax_np(scores, dst, n)
    deg = np.bincount(dst, minlength=n)[dst][:, None]
    smax = np.full((n, H), -np.inf)
    np.maximum.at(smax, dst, scores.astype(np.float64))
    spread = np.abs(scores - smax[dst])
    tol = (deg + 4 + spread) * 2.0 ** -23 * np.abs(want)
    err = np.abs(got.cpu().numpy().astype(np.float64) - want)
    assert np.all(err <= tol), float((err / np.maximum(tol, 1e-45)).max())
    plain = es_ref.edge_softmax_ref(s_d, d_d, n)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-6)


def _softmax_check(cuda_dev, scores, dst, n, offset=0):
    """The kernel within ``(deg + 4 + |s - m|) * 2^-23`` relative of the
    float64 oracle (as above), bitwise on a rerun; ``scores`` at a base
    ``offset`` floats past an aligned one."""
    s_d = _table_at(cuda_dev, scores, offset)
    d_d = torch.from_numpy(dst).to(cuda_dev)
    got = es_ops.edge_softmax(s_d, d_d, n)
    again = es_ops.edge_softmax(s_d, d_d, n)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = es_ref.edge_softmax_np(scores, dst, n)
    deg = np.bincount(dst, minlength=n)[dst][:, None]
    smax = np.full((n, scores.shape[1]), -np.inf)
    np.maximum.at(smax, dst, scores.astype(np.float64))
    tol = (deg + 4 + np.abs(scores - smax[dst])) * 2.0 ** -23 * np.abs(want)
    err = np.abs(got.cpu().numpy().astype(np.float64) - want)
    assert np.all(err <= tol), float((err / np.maximum(tol, 1e-45)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("H", [1, 3, 4, 8, 12])
def test_cuda_edge_softmax_hub_row_takes_a_block(cuda_dev, H, offset, rng):
    """A 30,000-edge hub and a 700-edge row, both above the block
    threshold, among warp rows and empty rows; 12 heads run as two head
    groups (8 + 4)."""
    scores, dst = _softmax_inputs(rng, 600, 3000, H, hub=30000)
    dst = np.sort(np.concatenate([dst, np.full(700, 10, np.int32)]))
    scores = rng.standard_normal((dst.size, H), dtype=np.float32)
    assert 700 > es_ops.HEAVY_EDGES
    _softmax_check(cuda_dev, scores, dst, 600, offset)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1, 4, 8])
def test_cuda_edge_softmax_many_block_rows(cuda_dev, H, rng, monkeypatch):
    """A threshold of 3 edges: most rows take a block, the list's tail
    (rows of 3 edges or fewer) exits and warps take those rows."""
    monkeypatch.setattr(es_ops, "HEAVY_EDGES", 3)
    scores, dst = _softmax_inputs(rng, 500, 4000, H)
    _softmax_check(cuda_dev, scores, dst, 500)


@pytest.mark.cuda
def test_cuda_edge_softmax_autograd_matches_plain_backward(cuda_dev, rng):
    scores, dst = _softmax_inputs(rng, 300, 2500, 4)
    d_attn = rng.standard_normal(scores.shape, dtype=np.float32)
    s_d, d_d, g_d = _on(cuda_dev, scores, dst, d_attn)
    s_d.requires_grad_(True)
    attn = es_ops.EdgeSoftmax.apply(s_d, d_d, 300)
    (got,) = torch.autograd.grad(attn, s_d, g_d)
    s_c = torch.from_numpy(scores).requires_grad_(True)
    attn_c = es_ref.edge_softmax_ref(s_c, torch.from_numpy(dst), 300)
    (want,) = torch.autograd.grad(attn_c, s_c, torch.from_numpy(d_attn))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_cuda_edge_softmax_refuses_bad_inputs(cuda_dev):
    s = torch.zeros(6, 2, device=cuda_dev)
    d = torch.zeros(6, dtype=torch.int32, device=cuda_dev)
    before = es_ops.LAUNCHES["edge_softmax"]
    with pytest.raises(TypeError):
        es_ops.edge_softmax(s.double(), d, 3)
    with pytest.raises(TypeError):
        es_ops.edge_softmax(s, d.long(), 3)
    with pytest.raises(ValueError, match="expected"):
        es_ops.edge_softmax(s, d.cpu(), 3)
    with pytest.raises(ValueError, match="contiguous"):
        es_ops.edge_softmax(torch.zeros(2, 6, device=cuda_dev).t(), d, 3)
    with pytest.raises(ValueError, match="n_dst=0"):
        es_ops.edge_softmax(s, d, 0)
    assert es_ops.LAUNCHES["edge_softmax"] == before


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN where the other is NaN (the card's NaN has its
    own bits, so this is bitwise up to the NaN payload)."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("V,D,n_bags,bag", [
    (300, 256, 64, 16), (100, 7, 33, 6), (50, 16, 9, 3), (1000, 1, 17, 5),
    (64, 33, 40, 1), (500, 132, 8, 40),
])
def test_cuda_embedding_bag_bitwise_vs_plain(cuda_dev, V, D, n_bags, bag,
                                             mode, rng):
    table = rng.standard_normal((V, D), dtype=np.float32)
    ids = rng.integers(0, V, (n_bags, bag)).astype(np.int32)
    if bag > 1:
        ids[::2, 1] = ids[::2, 0]          # duplicate rows inside a bag
    t_d, i_d = _on(cuda_dev, table, ids)
    before = eb_ops.LAUNCHES["embedding_bag"]
    got = eb_ops.embedding_bag(t_d, i_d, mode)
    torch.cuda.synchronize()
    assert eb_ops.LAUNCHES["embedding_bag"] == before + 1
    assert torch.equal(got, eb_ref.embedding_bag_ref(t_d, i_d, mode))
    want = table[ids].sum(1, dtype=np.float64)
    if mode == "mean":
        want /= bag
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5, atol=1e-5)
    # a table view that is not 16-byte aligned takes the scalar path
    if D % 4 == 0:
        big = torch.zeros(V * D + 1, device=cuda_dev)
        big[1:] = t_d.reshape(-1)
        assert torch.equal(eb_ops.embedding_bag(big[1:].view(V, D), i_d, mode),
                           got)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [5, 16])
def test_cuda_embedding_bag_wraps_and_nans(cuda_dev, D, rng):
    V = 12
    table = rng.standard_normal((V, D), dtype=np.float32)
    ids = np.array([[1, -1, 3], [V, 0, 2], [-V, 4, 4], [-V - 1, 5, 6],
                    [7, 8, 9], [2, -5, 11]], np.int32)
    t_d, i_d = _on(cuda_dev, table, ids)
    for mode in ("sum", "mean"):
        got = eb_ops.embedding_bag(t_d, i_d, mode)
        torch.cuda.synchronize()
        assert _same(got, eb_ref.embedding_bag_ref(t_d, i_d, mode))
        nan_rows = torch.isnan(got).all(1).cpu().tolist()
        assert nan_rows == [False, True, False, True, False, False]
        assert not torch.isnan(got[[0, 2, 4, 5]]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_cuda_embedding_bag_backward_through_scatter_add(cuda_dev, mode, rng):
    """The kernel route's gradient (the ``scatter_add_`` kernel) equals the
    reference route's and the ``np.add.at`` oracle bitwise."""
    V, D, n_bags, bag = 200, 24, 300, 6
    table = rng.standard_normal((V, D), dtype=np.float32)
    ids = rng.integers(-V, V, (n_bags, bag)).astype(np.int32)
    ids[5, 2] = V + 3                      # names no row: adds nothing
    d_out = rng.standard_normal((n_bags, D), dtype=np.float32)
    grads = {}
    before = dict(eb_ops.LAUNCHES, **ops.LAUNCHES)
    for kernels in ("kernel", "reference"):
        t_d = torch.from_numpy(table).to(cuda_dev).requires_grad_(True)
        out = eb_ops.EmbeddingBag.apply(t_d, _on(cuda_dev, ids)[0], mode,
                                        kernels)
        (grads[kernels],) = torch.autograd.grad(
            out, t_d, _on(cuda_dev, d_out)[0])
    torch.cuda.synchronize()
    assert eb_ops.LAUNCHES["embedding_bag"] == before["embedding_bag"] + 1
    assert ops.LAUNCHES["scatter_add"] == before["scatter_add"] + 1
    assert torch.equal(grads["kernel"], grads["reference"])
    flat = ids.reshape(-1).astype(np.int64)
    flat = np.where(flat < 0, flat + V, flat)
    ok = flat < V
    vals = d_out[np.arange(flat.size) // bag]
    if mode == "mean":
        vals = vals / np.float32(bag)
    want = np.zeros((V, D), np.float32)
    np.add.at(want, flat[ok], vals[ok])
    np.testing.assert_array_equal(grads["kernel"].cpu().numpy(), want)


@pytest.mark.cuda
def test_cuda_embedding_bag_refuses_bad_inputs(cuda_dev):
    t = torch.zeros(8, 4, device=cuda_dev)
    ids = torch.zeros(3, 2, dtype=torch.int32, device=cuda_dev)
    before = eb_ops.LAUNCHES["embedding_bag"]
    with pytest.raises(TypeError):
        eb_ops.embedding_bag(t, ids.long())
    with pytest.raises(TypeError):
        eb_ops.embedding_bag(t.double(), ids)
    with pytest.raises(ValueError, match="expected"):
        eb_ops.embedding_bag(t, ids.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        eb_ops.embedding_bag(torch.zeros(4, 8, device=cuda_dev).t(), ids)
    with pytest.raises(ValueError, match="mode"):
        eb_ops.embedding_bag(t, ids, "max")
    assert eb_ops.embedding_bag(t, ids[:0]).shape == (0, 4)
    assert eb_ops.LAUNCHES["embedding_bag"] == before


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bits (-0 differs from +0), NaN where the other is NaN."""
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def _bag_bitwise(t_d, ids, mode):
    """One kernel launch (counted once), bitwise the plain version."""
    i_d = torch.from_numpy(ids).to(t_d.device)
    before = eb_ops.LAUNCHES["embedding_bag"]
    got = eb_ops.embedding_bag(t_d, i_d, mode)
    torch.cuda.synchronize()
    assert eb_ops.LAUNCHES["embedding_bag"] == before + 1
    assert _bits(got, eb_ref.embedding_bag_ref(t_d, i_d, mode))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("D", [1, 7, 129, 256, 1024])
def test_cuda_embedding_bag_tiles_share_rows_bitwise(cuda_dev, D, mode, rng):
    """Repeats inside a bag and across the bags of a tile (the first tile's
    128 slots all one id), -1 beside V - 1 in one tile, a repeated invalid
    id, a -0 row, and 43 bags (not a multiple of the tile of 8)."""
    V, n_bags, bag = 300, 43, 16
    table = rng.standard_normal((V, D), dtype=np.float32)
    table[5] = -0.0
    ids = rng.integers(0, V, (n_bags, bag)).astype(np.int32)
    ids[:8] = 7                                  # one tile, one row
    ids[8:16, ::2] = ids[8:16, :1]               # repeats inside bags
    ids[16:24, :4] = 11                          # and across them
    ids[24, :2], ids[25, 3] = [-1, V - 1], -1    # one row, two ids
    ids[26, 1] = ids[26, 9] = ids[27, 0] = V + 3  # a repeated invalid id
    ids[28] = 5
    t_d = torch.from_numpy(table).to(cuda_dev)
    got = _bag_bitwise(t_d, ids, mode)
    assert torch.isnan(got[26:28]).all() and not torch.isnan(got[:26]).any()
    assert torch.signbit(got[28]).all()          # -0 summed from row 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("bag", [1, 40, 128, 300, 600])
def test_cuda_embedding_bag_bag_sizes_bitwise(cuda_dev, bag, mode, rng):
    """One id a bag, 40, a fill's most (128), and bags that span three and
    five fills, their sums carried between fills."""
    V, D, n_bags = 1000, 68, 21
    table = rng.standard_normal((V, D), dtype=np.float32)
    ids = rng.integers(-V, V, (n_bags, bag)).astype(np.int32)
    if bag > 1:
        ids[::3, bag // 2:] = ids[::3, :1]
    ids[4, -1] = -V - 1                          # NaN in the last fill
    _bag_bitwise(torch.from_numpy(table).to(cuda_dev), ids, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 256])
def test_cuda_embedding_bag_unaligned_view_bitwise(cuda_dev, D, rng):
    """A table view one float past an aligned base takes single floats: the
    same bits as the aligned table."""
    V, n_bags, bag = 500, 37, 16
    table = rng.standard_normal((V, D), dtype=np.float32)
    ids = rng.integers(0, V, (n_bags, bag)).astype(np.int32)
    ids[::4, :8] = ids[::4, :1]
    aligned = _bag_bitwise(_table_at(cuda_dev, table, 0), ids, "mean")
    view = _table_at(cuda_dev, table, 1)
    assert eb_ops.launch_plan(n_bags, bag, D, view.data_ptr() % 16 == 0
                              ).route == "scalar"
    assert torch.equal(_bag_bitwise(view, ids, "mean"), aligned)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bags", [8, 4096])
def test_cuda_embedding_bag_small_batches_bitwise(cuda_dev, n_bags, rng):
    """The batch-1 query's 8 bags split their columns over 8 blocks; the
    serve_p99 batch's 4,096 bags do not need to."""
    V, D, bag = 100000, 256, 16
    table = rng.standard_normal((V, D), dtype=np.float32)
    ids = rng.integers(0, V, (n_bags, bag)).astype(np.int32)
    p = eb_ops.launch_plan(n_bags, bag, D, True, sms=eb_ops._sms(cuda_dev))
    assert (p.parts > 1) == (n_bags == 8)
    _bag_bitwise(torch.from_numpy(table).to(cuda_dev), ids, "mean")


@pytest.mark.cuda
def test_cuda_embedding_bag_rerun_bitwise(cuda_dev):
    """A serving-like call twice: the same bits (no order depends on the
    run)."""
    gen = torch.Generator(device=cuda_dev).manual_seed(0)
    table = torch.randn((1_000_000, 256), generator=gen, device=cuda_dev)
    ids = torch.randint(0, 1_000_000, (65536, 16), generator=gen,
                        device=cuda_dev, dtype=torch.int32)
    before = eb_ops.LAUNCHES["embedding_bag"]
    a = eb_ops.embedding_bag(table, ids, "mean")
    b = eb_ops.embedding_bag(table, ids, "mean")
    torch.cuda.synchronize()
    assert eb_ops.LAUNCHES["embedding_bag"] == before + 2
    assert _bits(a, b) and _bits(a, eb_ref.embedding_bag_ref(table, ids,
                                                             "mean"))


@pytest.mark.cuda
def test_cuda_embedding_bag_refused_plan_raises(cuda_dev, monkeypatch):
    """A plan the kernel does not take is refused with an error code, which
    the wrapper raises; nothing is launched or counted."""
    t = torch.zeros(8, 4, device=cuda_dev)
    ids = torch.zeros(3, 2, dtype=torch.int32, device=cuda_dev)
    good = eb_ops.launch_plan(3, 2, 4, True)
    bad = dataclasses.replace(good, smem=good.smem + 16)
    monkeypatch.setattr(eb_ops, "launch_plan", lambda *a, **k: bad)
    before = eb_ops.LAUNCHES["embedding_bag"]
    with pytest.raises(RuntimeError, match="launch failed"):
        eb_ops.embedding_bag(t, ids)
    assert eb_ops.LAUNCHES["embedding_bag"] == before


# ---------------------------------------------------------------- flash
def _fa_inputs(rng, B, Sq, Skv, Hq, Hkv, D):
    return (rng.standard_normal((B, Sq, Hq, D), dtype=np.float32),
            rng.standard_normal((B, Skv, Hkv, D), dtype=np.float32),
            rng.standard_normal((B, Skv, Hkv, D), dtype=np.float32))


# the JAX kernel tests' grid (tests/test_kernels.py), a ragged S, Sq != Skv
# both ways, D 64 and the LM smoke's D 8
FA_SHAPES = [(1, 128, 128, 4, 4, 32), (2, 256, 256, 8, 2, 64),
             (1, 512, 512, 4, 1, 128), (1, 200, 200, 4, 2, 128),
             (1, 96, 200, 8, 2, 64), (1, 200, 160, 4, 2, 64),
             (2, 40, 40, 8, 2, 8)]
FA_MASKS = [(True, None), (True, 64), (False, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", FA_MASKS)
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D", FA_SHAPES)
def test_cuda_flash_attention_f32_vs_float64_oracle(cuda_dev, B, Sq, Skv, Hq,
                                                    Hkv, D, causal, window,
                                                    rng):
    if window is not None and Sq > Skv + window - 1:
        pytest.skip("a row with no key: refused (see the refusal test)")
    q, k, v = _fa_inputs(rng, B, Sq, Skv, Hq, Hkv, D)
    before = fa_ops.LAUNCHES["flash_attention"]
    got = fa_ops.flash_attention(*_on(cuda_dev, q, k, v), causal, window)
    torch.cuda.synchronize()
    assert fa_ops.LAUNCHES["flash_attention"] == before + 1
    want = fa_ref.attention_np(q, k, v, causal, window)
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", FA_MASKS)
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D", FA_SHAPES)
def test_cuda_flash_attention_bf16_within_one_ulp_of_plain(
    cuda_dev, B, Sq, Skv, Hq, Hkv, D, causal, window, rng,
):
    if window is not None and Sq > Skv + window - 1:
        pytest.skip("a row with no key: refused (see the refusal test)")
    q, k, v = (t.to(torch.bfloat16) for t in
               _on(cuda_dev, *_fa_inputs(rng, B, Sq, Skv, Hq, Hkv, D)))
    got = fa_ops.flash_attention(q, k, v, causal, window)
    plain = fa_ref.flash_attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert fa_ref.within_one_bf16_ulp(got, plain)
    assert torch.equal(fa_ops.flash_attention(q, k, v, causal, window), got)


@pytest.mark.cuda
def test_cuda_flash_attention_gqa_head_order(cuda_dev, rng):
    """Query head h reads KV head h // G: each KV head's keys, alone, give
    its G query heads' output."""
    B, S, Hq, Hkv, D = 1, 130, 6, 3, 32
    q, k, v = _on(cuda_dev, *_fa_inputs(rng, B, S, S, Hq, Hkv, D))
    got = fa_ops.flash_attention(q, k, v)
    G = Hq // Hkv
    for h in range(Hq):
        one = fa_ops.flash_attention(
            q[:, :, h:h + 1].contiguous(),
            k[:, :, h // G:h // G + 1].contiguous(),
            v[:, :, h // G:h // G + 1].contiguous())
        torch.testing.assert_close(one[:, :, 0], got[:, :, h], rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_bad_inputs(cuda_dev):
    q = torch.zeros(1, 8, 4, 16, device=cuda_dev)
    k = torch.zeros(1, 8, 2, 16, device=cuda_dev)
    before = fa_ops.LAUNCHES["flash_attention"]
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q, k.to(torch.bfloat16), k)
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_attention(q, k.transpose(1, 2).contiguous().transpose(
            1, 2), k)
    with pytest.raises(ValueError, match="multiple"):
        fa_ops.flash_attention(torch.zeros(1, 8, 3, 16, device=cuda_dev), k,
                               k)
    with pytest.raises(ValueError, match="on"):
        fa_ops.flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError, match="on"):
        fa_ops.flash_attention(q.cpu(), k, k)
    with pytest.raises(ValueError, match="D=160"):
        z = torch.zeros(1, 8, 2, 160, device=cuda_dev)
        fa_ops.flash_attention(z, z, z)
    with pytest.raises(ValueError, match="no key"):
        fa_ops.flash_attention(torch.zeros(1, 20, 4, 16, device=cuda_dev),
                               k, k, causal=False, window=4)
    assert fa_ops.LAUNCHES["flash_attention"] == before


def _fa_bf16(dev, seed, B, Sq, Skv, Hq, Hkv, D):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((B, Sq, Hq, D), generator=gen, device=dev).bfloat16(),
            torch.randn((B, Skv, Hkv, D), generator=gen, device=dev).bfloat16(),
            torch.randn((B, Skv, Hkv, D), generator=gen, device=dev).bfloat16())


@pytest.mark.cuda
def test_cuda_flash_attention_bf16_long_causal_vs_plain(cuda_dev):
    """The prefill's checks at S 4,096 (GQA 8 / 2 heads of 128, causal):
    within 2^-7 |plain| + 1e-6 elementwise, at least 99% of the elements
    bitwise equal to plain, a rerun bitwise."""
    q, k, v = _fa_bf16(cuda_dev, 1, 1, 4096, 4096, 8, 2, 128)
    got = fa_ops.flash_attention(q, k, v)
    plain = fa_ref.flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    err = (got.float() - plain.float()).abs()
    assert bool(torch.all(err <= 2.0 ** -7 * plain.float().abs() + 1e-6))
    assert float((got == plain).float().mean()) >= 0.99
    assert torch.equal(fa_ops.flash_attention(q, k, v), got)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_bf16_window_skips_tiles(cuda_dev, causal):
    """A window of 64 over 4,096 keys: each query tile reads at most two of
    the 32 KV tiles, the rest are skipped; within 1 bf16 ulp of plain and
    bitwise on a rerun."""
    q, k, v = _fa_bf16(cuda_dev, 2, 1, 4096, 4096, 4, 2, 128)
    got = fa_ops.flash_attention(q, k, v, causal, 64)
    plain = fa_ref.flash_attention_ref(q, k, v, causal, 64)
    torch.cuda.synchronize()
    assert fa_ref.within_one_bf16_ulp(got, plain)
    assert torch.equal(fa_ops.flash_attention(q, k, v, causal, 64), got)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [20, 72])
@pytest.mark.parametrize("offset", [0, 1])
def test_cuda_flash_attention_bf16_odd_widths_and_bases(cuda_dev, D, offset):
    """Tensors TMA cannot take (D * 2 not a multiple of 16, or a base that
    is not 16-byte aligned: a view one element into its buffer) are loaded
    by the producer's threads in the same kernel: within 1 bf16 ulp of
    plain, one launch each."""
    B, Sq, Skv, Hq, Hkv = 1, 200, 200, 4, 2
    qf, kf, vf = _fa_bf16(cuda_dev, 3, B, Sq, Skv, Hq, Hkv, D)

    def shifted(t):
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        out = buf[offset:].view(t.shape)
        out.copy_(t)
        return out

    q, k, v = shifted(qf), shifted(kf), shifted(vf)
    for causal, window in FA_MASKS:
        before = fa_ops.LAUNCHES["flash_attention"]
        got = fa_ops.flash_attention(q, k, v, causal, window)
        plain = fa_ref.flash_attention_ref(q, k, v, causal, window)
        torch.cuda.synchronize()
        assert fa_ops.LAUNCHES["flash_attention"] == before + 1
        assert fa_ref.within_one_bf16_ulp(got, plain)


# ---------------------------------------------------------------- bsr_spmm
# the JAX kernel tests' grid (tests/test_kernels.py), a ragged D, B 64 and 8
BS_SHAPES = [(300, 2000, 64, 128), (700, 5000, 128, 128),
             (128, 400, 96, 128), (513, 3000, 32, 128), (200, 900, 7, 128),
             (150, 700, 20, 64), (40, 300, 70, 8)]


def _bs_inputs(rng, n, E, D, block):
    src = rng.integers(0, n, E)
    dst = rng.integers(0, n, E)
    w = rng.standard_normal(E).astype(np.float32)
    a, rows, cols, nb = bs_ops.blockify_edges(src, dst, w, n, block=block)
    x = rng.standard_normal((nb, block, D)).astype(np.float32)
    return a, rows, cols, x, nb


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,E,D,block", BS_SHAPES)
def test_cuda_bsr_spmm_within_bound_of_plain(cuda_dev, n, E, D, block, dtype,
                                             rng):
    """float32: within ``(m_r + 1) * 2^-23 * (|A| |X|)_r`` (``m_r`` the
    row's nonzero entries of A) of the plain version per element
    (``bsr_spmm_tolerance``) and of the float64
    oracle. bfloat16 x: within one bf16 ulp of plain, or within that
    float32 term where it is larger (both sum in float32 and round once)."""
    a, rows, cols, x, nb = _bs_inputs(rng, n, E, D, block)
    a_d, r_d, c_d, x_d = _on(cuda_dev, a, rows, cols, x)
    x_d = x_d.to(dtype)
    before = bs_ops.LAUNCHES["bsr_spmm"]
    got = bs_ops.bsr_spmm_kernel(a_d, r_d, c_d, x_d, nb)
    torch.cuda.synchronize()
    assert bs_ops.LAUNCHES["bsr_spmm"] == before + 1
    assert got.dtype == dtype and got.shape == (nb, block, D)
    plain = bs_ref.bsr_spmm_ref(a_d, r_d, c_d, x_d, nb)
    tol = bs_ref.bsr_spmm_tolerance(a_d, r_d, c_d, x_d, nb)
    err = (got.float() - plain.float()).abs()
    if dtype == torch.float32:
        assert bool(torch.all(err <= tol)), float((err - tol).max())
        want = bs_ref.bsr_spmm_np(a, rows, cols, x, nb)
        assert np.all(np.abs(got.cpu().numpy() - want) <= tol.cpu().numpy())
    else:
        assert bool(torch.all((fa_ref.bf16_ulp_distance(got, plain) <= 1)
                              | (err <= tol)))


@pytest.mark.cuda
def test_cuda_bsr_spmm_empty_rows_are_zero(cuda_dev, rng):
    """Destination block rows with no nonzero block come back 0 (the
    reference's Pallas kernel leaves them unwritten): the reference fault's
    repro at B 8, a wide one at B 128 with rows 0, 2 and the last empty,
    and no block at all."""
    src, dst = np.array([0, 9, 17, 3]), np.array([1, 2, 20, 21])
    cases = [(src, dst, 32, 20, 8)]
    src = rng.integers(0, 1024, 4000)
    dst = rng.integers(0, 1024, 4000)
    keep = ~np.isin(dst // 128, [0, 2, 7])
    cases.append((src[keep], dst[keep], 1024, 200, 128))
    cases.append((src[:0], dst[:0], 256, 64, 128))
    for src, dst, n, D, block in cases:
        w = rng.standard_normal(src.size).astype(np.float32)
        a, rows, cols, nb = bs_ops.blockify_edges(src, dst, w, n, block=block)
        x = rng.standard_normal((n, D)).astype(np.float32)
        a_d, r_d, c_d, x_d = _on(cuda_dev, a, rows, cols, x)
        got = bs_ops.bsr_spmm(x_d, a_d, r_d, c_d, nb, block=block)
        torch.cuda.synchronize()
        empty = np.setdiff1d(np.arange(nb), rows)
        blocks = got.view(nb, block, D).cpu()
        assert empty.size and not blocks[empty].any()
        want = bs_ref.spmm_edges_np(src, dst, w, x, n)
        tol = (np.bincount(dst, minlength=n)[:, None] + 1) * 2.0 ** -23 * \
            bs_ref.spmm_edges_np(src, dst, np.abs(w), np.abs(x), n)
        assert np.all(np.abs(got.cpu().numpy() - want) <= tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_bsr_spmm_rerun_bitwise(cuda_dev, dtype, rng):
    a, rows, cols, x, nb = _bs_inputs(rng, 2000, 40000, 300, 128)
    a_d, r_d, c_d, x_d = _on(cuda_dev, a, rows, cols, x)
    x_d = x_d.to(dtype)
    one = bs_ops.bsr_spmm_kernel(a_d, r_d, c_d, x_d, nb)
    two = bs_ops.bsr_spmm_kernel(a_d, r_d, c_d, x_d, nb)
    torch.cuda.synchronize()
    assert torch.equal(one, two)


@pytest.mark.cuda
def test_cuda_bsr_spmm_refuses_bad_inputs(cuda_dev):
    a = torch.zeros(2, 8, 8, device=cuda_dev)
    ids = torch.zeros(2, dtype=torch.int32, device=cuda_dev)
    x = torch.zeros(4, 8, 16, device=cuda_dev)
    before = bs_ops.LAUNCHES["bsr_spmm"]
    with pytest.raises(TypeError):
        bs_ops.bsr_spmm_kernel(a.double(), ids, ids, x, 4)
    with pytest.raises(TypeError):
        bs_ops.bsr_spmm_kernel(a, ids.long(), ids, x, 4)
    with pytest.raises(TypeError):
        bs_ops.bsr_spmm_kernel(a, ids, ids, x.half(), 4)
    with pytest.raises(ValueError, match="expected"):
        bs_ops.bsr_spmm_kernel(a, ids.cpu(), ids, x, 4)
    with pytest.raises(ValueError, match="expected"):
        bs_ops.bsr_spmm_kernel(a.cpu(), ids, ids, x, 4)
    with pytest.raises(ValueError, match="n_src_blocks, B=8"):
        bs_ops.bsr_spmm_kernel(a, ids, ids, x.view(2, 16, 16), 4)
    with pytest.raises(ValueError, match="contiguous"):
        bs_ops.bsr_spmm_kernel(a, ids, ids, x.transpose(0, 1).contiguous()
                               .transpose(0, 1), 4)
    with pytest.raises(ValueError, match="contiguous"):
        bs_ops.bsr_spmm(torch.zeros(16, 32, device=cuda_dev).t(), a, ids,
                        ids, 4, block=8)
    with pytest.raises(ValueError, match="sorted"):
        bs_ops.bsr_spmm_kernel(a, torch.tensor([1, 0], dtype=torch.int32,
                                                device=cuda_dev), ids, x, 4)
    with pytest.raises(ValueError, match="B=256"):
        big = torch.zeros(1, 256, 256, device=cuda_dev)
        bs_ops.bsr_spmm_kernel(big, ids[:1], ids[:1],
                               torch.zeros(1, 256, 4, device=cuda_dev), 1)
    assert bs_ops.LAUNCHES["bsr_spmm"] == before


def _bs_check(cuda_dev, a, rows, cols, x, nb, dtype=torch.float32):
    """The kernel against plain within ``bsr_spmm_tolerance`` (bf16: or
    within 1 ulp), block rows with no block exactly 0, a rerun bitwise;
    returns the kernel's output."""
    a_d, r_d, c_d, x_d = _on(cuda_dev, a, rows, cols, x)
    x_d = x_d.to(dtype)
    got = bs_ops.bsr_spmm_kernel(a_d, r_d, c_d, x_d, nb)
    plain = bs_ref.bsr_spmm_ref(a_d, r_d, c_d, x_d, nb)
    tol = bs_ref.bsr_spmm_tolerance(a_d, r_d, c_d, x_d, nb)
    torch.cuda.synchronize()
    err = (got.float() - plain.float()).abs()
    ok = err <= tol
    if dtype == torch.bfloat16:
        ok |= fa_ref.bf16_ulp_distance(got, plain) <= 1
    assert bool(torch.all(ok)), float((err - tol).max())
    empty = np.setdiff1d(np.arange(nb), rows)
    assert not bool(got[torch.from_numpy(empty).to(cuda_dev)].any())
    assert torch.equal(bs_ops.bsr_spmm_kernel(a_d, r_d, c_d, x_d, nb), got)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_bsr_spmm_dense_zero_and_hub_blocks(cuda_dev, dtype, rng):
    """A fully dense block, an all-zero block listed in the row ids, and a
    hub block row whose rows take 300 nonzero entries each, past the 128 a
    row's bucket holds, so it is done in chunks (row 1 of 4 is empty)."""
    B, D, nb = 128, 200, 4
    blocks = [(0, 0, rng.standard_normal((B, B))),           # dense
              (0, 2, np.zeros((B, B))),                      # all zero
              (2, 3, np.where(rng.random((B, B)) < 0.05,
                              rng.standard_normal((B, B)), 0.0))]
    for c in range(4):                                       # the hub row
        blocks.append((3, c, np.where(rng.random((B, B)) < 0.6,
                                      rng.standard_normal((B, B)), 0.0)))
    blocks.sort(key=lambda t: (t[0], t[1]))
    a = np.stack([t[2] for t in blocks]).astype(np.float32)
    rows = np.array([t[0] for t in blocks], np.int32)
    cols = np.array([t[1] for t in blocks], np.int32)
    x = rng.standard_normal((nb, B, D)).astype(np.float32)
    assert (a[rows == 3] != 0).sum(axis=(0, 2)).min() > 128
    _bs_check(cuda_dev, a, rows, cols, x, nb, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_bsr_spmm_ragged_block_and_width(cuda_dev, dtype, rng):
    """B 100 and D 200 (neither a multiple of 32 nor of the 128-column
    tile), some block rows empty."""
    src = rng.integers(0, 1000, 6000)
    dst = rng.integers(0, 1000, 6000)
    dst = dst[~np.isin(dst // 100, [1, 6])]
    src = src[:dst.size]
    w = rng.standard_normal(dst.size).astype(np.float32)
    a, rows, cols, nb = bs_ops.blockify_edges(src, dst, w, 1000, block=100)
    x = rng.standard_normal((nb, 100, 200)).astype(np.float32)
    _bs_check(cuda_dev, a, rows, cols, x, nb, dtype)


@pytest.mark.cuda
def test_cuda_bsr_spmm_skips_zero_entries_of_nonfinite_x(cuda_dev, rng):
    """The kernel multiplies only the nonzero entries of A, so an inf or
    NaN in a row of x reaches only the outputs whose row has a nonzero
    entry against it; the dense product (and the plain version) turns every
    row of a block that holds it into NaN (0 * inf). A deliberate change,
    listed in ROADMAP's divergences."""
    src = rng.integers(0, 256, 900)
    dst = rng.integers(0, 256, 900)
    w = rng.standard_normal(src.size).astype(np.float32)
    a, rows, cols, nb = bs_ops.blockify_edges(src, dst, w, 256)
    x = rng.standard_normal((nb, 128, 16)).astype(np.float32)
    s_inf, s_nan = int(src[0]), int(src[1])
    x.reshape(-1, 16)[s_inf, 3] = np.inf
    x.reshape(-1, 16)[s_nan, 5] = np.nan
    a_d, r_d, c_d, x_d = _on(cuda_dev, a, rows, cols, x)
    got = bs_ops.bsr_spmm_kernel(a_d, r_d, c_d, x_d, nb).view(-1, 16).cpu()
    plain = bs_ref.bsr_spmm_ref(a_d, r_d, c_d, x_d, nb).view(-1, 16).cpu()
    torch.cuda.synchronize()
    # float64 sums over A's nonzero entries, and where they are not finite
    blk, i, kk = np.nonzero(a)
    d_idx = rows[blk].astype(np.int64) * 128 + i
    s_idx = cols[blk].astype(np.int64) * 128 + kk
    x2 = x.reshape(-1, 16)
    want = bs_ref.spmm_edges_np(s_idx, d_idx, a[blk, i, kk], x2, nb * 128)
    bad = ~np.isfinite(want)
    assert bad.any()
    g = got.numpy()
    assert np.array_equal(~np.isfinite(g), bad)
    assert np.array_equal(np.isnan(g), np.isnan(want))
    tol = (np.bincount(d_idx, minlength=nb * 128)[:, None] + 1) * 2.0 ** -23 \
        * bs_ref.spmm_edges_np(s_idx, d_idx, np.abs(a[blk, i, kk]),
                               np.abs(np.nan_to_num(x2, posinf=0.0)), nb * 128)
    assert np.all(np.abs(g[~bad] - want[~bad]) <= tol[~bad])
    # plain: NaN on more outputs (every row of a block column that holds
    # the inf or NaN)
    assert int(torch.isnan(plain).sum()) > int(np.isnan(g).sum())
