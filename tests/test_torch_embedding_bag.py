"""The port's ``embedding_bag`` (the wrapper on CPU tensors, which runs the
plain version; the ``EmbeddingBag`` backward; the model's general
``embedding_bag``) against the reference: the JAX Pallas kernel in
interpret mode, its ``embedding_bag_ref`` oracle and the two-tower model's
``embedding_bag``, on the same numpy inputs.

The CUDA kernel's launch plan (``ops.launch_plan``) is tested here too: the
route it gives each shape the main path launches at, its limits, and a walk
of the plan that repeats the kernel's index arithmetic, deduplication and
add chains in numpy, so every (bag, column) is written once and the result
equals the plain version bitwise.

Tolerance: 1e-6 relative to each result's largest magnitude — both sides
add the same float32 rows, in the same order where the order is defined
(the kernel and the oracle sum each bag in ``k`` order). The backward is
also held bitwise against ``np.add.at`` in input order. The CUDA kernel
itself is tested on the card (``tests/test_torch_cuda_kernels.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import (
    embedding_bag_kernel_call, embedding_bag_ref as jax_ref,
)
from repro.models.recsys.two_tower import embedding_bag as jax_model_bag

from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.embedding_bag import (
    LAUNCHES, EmbeddingBag, embedding_bag, embedding_bag_backward_ref,
    embedding_bag_ref,
)
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.models.recsys import two_tower as tt

RTOL = 1e-6


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.nanmax(np.abs(want))) if want.size else 0.0, 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _inputs(V, D, n_bags, bag, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, (n_bags, bag)).astype(np.int32)
    if bag > 1:
        ids[: n_bags // 2 + 1, 1] = ids[: n_bags // 2 + 1, 0]  # duplicates
    return table, ids


def _jax_model(table, ids, mode):
    n_bags, bag = ids.shape
    seg = np.repeat(np.arange(n_bags), bag).astype(np.int32)
    return np.asarray(jax_model_bag(
        jnp.asarray(table), jnp.asarray(ids.reshape(-1)), jnp.asarray(seg),
        n_bags, mode=mode))


# interpret mode runs the Pallas grid (n_bags, D / 128, bag) step by step:
# keep these grids tiny
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("V,D,n_bags,bag", [
    (50, 7, 16, 6), (40, 16, 5, 3), (30, 256, 3, 2),
])
def test_embedding_bag_matches_pallas_interpret(V, D, n_bags, bag, mode):
    table, ids = _inputs(V, D, n_bags, bag, seed=V + D)
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), mode)
    want = embedding_bag_kernel_call(jnp.asarray(table), jnp.asarray(ids),
                                     mode=mode, interpret=True)
    assert got.shape == (n_bags, D) and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("V,D,n_bags,bag", [
    (100, 7, 16, 6), (64, 16, 1, 1), (300, 16, 9, 4), (500, 256, 12, 5),
    (20, 256, 16, 1),
])
def test_embedding_bag_matches_oracle_and_model(V, D, n_bags, bag, mode):
    table, ids = _inputs(V, D, n_bags, bag, seed=3 * V + D)
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                        mode).numpy()
    _close(got, np.asarray(jax_ref(jnp.asarray(table), jnp.asarray(ids),
                                   mode=mode)))
    _close(got, _jax_model(table, ids, mode))
    # the plain version is what the wrapper ran: the same bits
    np.testing.assert_array_equal(
        got, embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(ids),
                               mode).numpy())


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_wraps_and_nans_like_jnp_take(mode):
    """``jnp.take`` (the model's lookup): ids in [-V, 0) wrap, any other id
    outside [0, V) makes its bag NaN; the other bags are unaffected."""
    V, D = 12, 5
    rng = np.random.default_rng(4)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = np.array([[1, -1, 3], [V, 0, 2], [-V, 4, 4], [-V - 1, 5, 6],
                    [7, 8, 9], [2, -5, 11]], np.int32)
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                        mode).numpy()
    want = _jax_model(table, ids, mode)
    nan_rows = np.isnan(got).all(axis=1)
    np.testing.assert_array_equal(nan_rows, [False, True, False, True,
                                             False, False])
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
    _close(got, want)
    wrapped = np.where(ids < 0, ids + V, ids)
    _close(got[0], table[wrapped[0]].sum(0) / (3.0 if mode == "mean" else 1.0))


def test_embedding_bag_degenerate_shapes_and_bad_args():
    table = torch.randn(10, 4)
    assert embedding_bag(table, torch.zeros((0, 3), dtype=torch.int32)).shape \
        == (0, 4)
    out = embedding_bag(table, torch.zeros((5, 0), dtype=torch.int32), "mean")
    assert out.shape == (5, 4) and not out.any()
    with pytest.raises(ValueError, match="mode"):
        embedding_bag(table, torch.zeros((2, 2), dtype=torch.int32), "max")
    with pytest.raises(ValueError, match="n_bags, bag_size"):
        embedding_bag(table, torch.zeros(4, dtype=torch.int32))


def _np_grad(d_out, ids, V, mode):
    """Oracle: ``np.add.at`` of each lookup's output gradient into its
    row, in input order; ids that name no row add nothing."""
    n_bags, bag = ids.shape
    flat = ids.reshape(-1).astype(np.int64)
    flat = np.where(flat < 0, flat + V, flat)
    valid = (flat >= 0) & (flat < V)
    vals = d_out[np.arange(flat.size) // bag]
    if mode == "mean":
        vals = vals / np.float32(bag)
    grad = np.zeros((V, d_out.shape[1]), np.float32)
    np.add.at(grad, flat[valid], vals[valid])
    return grad


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("V,D,n_bags,bag", [(40, 7, 16, 6), (300, 16, 9, 3),
                                            (64, 256, 4, 5)])
def test_embedding_bag_backward_matches_jax_vjp_and_np_add_at(V, D, n_bags,
                                                             bag, mode):
    table, ids = _inputs(V, D, n_bags, bag, seed=V * D + bag)
    ids[0, 0] = -2                    # wraps to V - 2
    ids[-1, -1] = ids[-2, -1] = 3     # one row shared across bags
    rng = np.random.default_rng(9)
    d_out = rng.standard_normal((n_bags, D)).astype(np.float32)
    t = torch.from_numpy(table).requires_grad_(True)
    out = EmbeddingBag.apply(t, torch.from_numpy(ids), mode, "kernel")
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(d_out))
    got = got.numpy()
    np.testing.assert_array_equal(got, _np_grad(d_out, ids, V, mode))

    seg = jnp.asarray(np.repeat(np.arange(n_bags), bag).astype(np.int32))
    _, vjp = jax.vjp(
        lambda tb: jax_model_bag(tb, jnp.asarray(ids.reshape(-1)), seg,
                                 n_bags, mode=mode), jnp.asarray(table))
    _close(got, np.asarray(vjp(jnp.asarray(d_out))[0]))


def test_embedding_bag_backward_drops_invalid_ids():
    V, D = 8, 3
    ids = np.array([[1, V], [-V - 2, 1], [2, 2]], np.int32)
    d_out = np.arange(9, dtype=np.float32).reshape(3, 3) + 1
    got = embedding_bag_backward_ref(torch.from_numpy(d_out),
                                     torch.from_numpy(ids), V, "sum").numpy()
    np.testing.assert_array_equal(got, _np_grad(d_out, ids, V, "sum"))
    assert not got[0].any() and got[1].any() and got[2].any()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_function_kernel_and_reference_routes_agree(mode):
    """On CPU tensors both routes run the plain versions: the same bits,
    and no kernel launch is counted."""
    table, ids = _inputs(60, 16, 10, 4, seed=11)
    reset_launches()
    res = {}
    for kernels in ("kernel", "reference"):
        t = torch.from_numpy(table).requires_grad_(True)
        out = EmbeddingBag.apply(t, torch.from_numpy(ids), mode, kernels)
        out.square().sum().backward()
        res[kernels] = (out.detach(), t.grad)
    assert all(torch.equal(a, b) for a, b in zip(res["kernel"],
                                                 res["reference"]))
    assert LAUNCHES["embedding_bag"] == 0
    assert not any(launch_counts().values())
    with pytest.raises(ValueError, match="kernels"):
        EmbeddingBag.apply(torch.from_numpy(table), torch.from_numpy(ids),
                           mode, "auto")


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_model_embedding_bag_matches_jax_model(mode, weighted):
    """The model's general ``embedding_bag``: unsorted, uneven bags, an
    empty bag, optional per-lookup weights; forward and table gradient."""
    V, D, n_bags, N = 50, 6, 7, 40
    rng = np.random.default_rng(5)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(-V, V, N).astype(np.int32)
    bag_ids = rng.integers(0, n_bags - 1, N).astype(np.int32)   # last empty
    w = rng.standard_normal(N).astype(np.float32) if weighted else None
    t = torch.from_numpy(table).requires_grad_(True)
    got = tt.embedding_bag(t, torch.from_numpy(ids), torch.from_numpy(bag_ids),
                           n_bags, mode,
                           None if w is None else torch.from_numpy(w))
    d_out = rng.standard_normal((n_bags, D)).astype(np.float32)
    (g,) = torch.autograd.grad(got, t, torch.from_numpy(d_out))
    want, vjp = jax.vjp(
        lambda tb: jax_model_bag(tb, jnp.asarray(ids), jnp.asarray(bag_ids),
                                 n_bags, mode,
                                 None if w is None else jnp.asarray(w)),
        jnp.asarray(table))
    _close(got.detach().numpy(), np.asarray(want))
    assert not got[-1].any()
    _close(g.numpy(), np.asarray(vjp(jnp.asarray(d_out))[0]))


# ------------------------------------------------------------ launch plan
# (n_bags, bag_size, D) of each shape the main path launches the kernel at
# (chip_smoke.py phase H): the two-tower CONFIG's towers at serving and
# training batches, the example's at its own size
MAIN_SHAPES = {
    "serve_p99": (4096, 16, 256), "serve_bulk": (2097152, 16, 256),
    "corpus chunk": (262144, 16, 256), "retrieval query": (8, 16, 256),
    "training user": (131072, 16, 256), "training item": (65536, 16, 256),
    "resume user": (8192, 8, 256), "resume item": (4096, 8, 256),
}


def _plan_ok(p, n_bags, bag, D):
    """The kernel's own check of a plan (``embedding_bag_f32``)."""
    W = 4 if p.vec else 1
    T = eb_ops.FILL_IDS
    stages = eb_ops.STAGES if p.blocks == 1 else eb_ops.STAGES_TWO_BLOCKS
    return (1 <= p.tile and 1 <= p.chunk <= min(bag, T)
            and (p.chunk == bag or p.tile == 1) and p.tile * p.chunk <= T
            and p.slab >= W and p.slab % W == 0
            and p.tile * ((p.slab // W + 1) // 2) <= eb_ops.CONSUMERS
            and p.stage % W == 0 and p.stage >= p.tile * p.chunk * W
            and (p.chunk == bag or p.slab <= p.stage // p.chunk)
            and p.parts >= 1
            and p.parts * p.slab >= D > (p.parts - 1) * p.slab
            and 1 <= p.grid <= -(-n_bags // p.tile) * p.parts
            and p.grid < 2 ** 31 and (not p.vec or D % 4 == 0)
            and p.blocks in (1, 2)
            and p.smem == eb_ops._meta_bytes(stages)
            + (stages * p.stage + p.slab) * 4
            and p.smem * p.blocks <= eb_ops.SMEM_LIMIT)


def _with_stage_bytes(p, n_bags, bag, D, stage_bytes):
    """The plan with stages of ``stage_bytes`` (None: as planned), its
    slab narrowed where a bag spans items and every id of an item must fit
    a stage at the slab's width."""
    if stage_bytes is None:
        return p
    W = 4 if p.vec else 1
    stage = stage_bytes // 4 // W * W
    slab = p.slab if p.chunk == bag else max(
        W, min(p.slab, stage // p.chunk // W * W))
    parts = -(-D // slab)
    return dataclasses.replace(
        p, stage=stage, slab=slab, parts=parts,
        grid=min(p.grid, -(-n_bags // p.tile) * parts),
        smem=eb_ops.smem_bytes(p.blocks, stage, slab))


def _fills(p, n_bags, bag):
    """Each block's fills in the kernel's order, from its cursor (advanced
    without a division): ``(block, tile, part, chunk)``. The producers and
    the consumers of a block walk the same sequence."""
    n_chunks = -(-bag // p.chunk)
    n_items = -(-n_bags // p.tile) * p.parts
    gt, gp = divmod(p.grid, p.parts)
    for blk in range(p.grid):
        tile, part = divmod(blk, p.parts)
        chunk = 0
        for _ in range(((n_items - 1 - blk) // p.grid + 1) * n_chunks):
            yield blk, tile, part, chunk
            chunk += 1
            if chunk == n_chunks:
                chunk, tile, part = 0, tile + gt, part + gp
                if part >= p.parts:
                    part, tile = part - p.parts, tile + 1


def _walk(p, table, ids, mode):
    """The kernel run in numpy: per item, the slots' rows (one a producer
    thread), the first slot naming each row (inside a warp, then earlier
    warps), then the item's fills: all its columns where its distinct rows
    fit a stage at that width, else stage-sized slabs; per fill the distinct
    rows' columns staged once and every value's add chain in ``k`` order (a
    consumer thread's two values: columns cv and cv + half of one bag).
    Returns the output and how often each (bag, column) was written."""
    (n_bags, bag), (V, D) = ids.shape, table.shape
    W, T = (4 if p.vec else 1), eb_ops.FILL_IDS
    flat = ids.reshape(-1).astype(np.int64)
    out = np.zeros((n_bags, D), np.float32)
    writes = np.zeros((n_bags, D), np.int64)
    n_chunks = -(-bag // p.chunk)
    slots = p.tile * p.chunk
    narrow = min(p.slab, p.stage // slots // W * W)
    tid = np.arange(T)
    cons = np.arange(eb_ops.CONSUMERS)
    acc = {}
    last = None
    for blk, tile, part, chunk in _fills(p, n_bags, bag):
        b0, k0 = tile * p.tile, chunk * p.chunk
        kn = min(p.chunk, bag - k0)
        n = p.tile * bag if n_chunks == 1 else kn
        assert n <= T
        id0 = b0 * bag + k0
        c0 = part * p.slab
        wc = min(p.slab, D - c0)
        if chunk:                          # a bag's chunks follow each other
            assert last == (blk, tile, part, chunk - 1)
        last = (blk, tile, part, chunk)
        g = id0 + tid
        has = (tid < n) & (g < n_bags * bag)
        r = np.where(has, flat[np.minimum(g, flat.size - 1)], 0)
        r = np.where(r < 0, r + V, r)
        r = np.where(has & (r >= 0) & (r < V), r, -1)
        first = np.empty(T, np.int64)
        for t in range(T):                 # first slot with the same row
            w0 = t // 32 * 32
            lead = w0 + np.flatnonzero(r[w0:t + 1] == r[t])[0]
            if lead < t:                   # the warp's leader's answer
                first[t] = first[lead]
                continue
            earlier = np.flatnonzero(r[:w0] == r[t]) if r[t] >= 0 else []
            first[t] = earlier[0] if len(earlier) else t
        is_first = (r >= 0) & (first == tid)
        uidx = np.cumsum(is_first) - 1
        uniq = r[is_first]
        U = uniq.size
        su = np.where(r >= 0, uidx[first], -1)
        wf = wc if U * wc <= p.stage else narrow
        if n_chunks > 1:                   # one fill a chunk: sums carry
            assert wf == wc
        for c in range(0, wc, wf):
            wcf = min(wf, wc - c)
            assert U * wcf <= p.stage
            stage = table[uniq, c0 + c:c0 + c + wcf]  # each row staged once
            wv = wcf // W
            half = (wv + 1) // 2
            tb, cv = cons // half, cons % half
            for col_v in (cv, cv + half):
                for t in np.flatnonzero((tb < p.tile) & (col_v < wv)
                                        & (cv < wv) & (b0 + tb < n_bags)):
                    b = b0 + tb[t]
                    cols = slice(col_v[t] * W, col_v[t] * W + W)
                    key = (t, col_v is cv)
                    for k in range(kn):
                        u = su[tb[t] * kn + k]
                        x = stage[u, cols] if u >= 0 else np.float32(np.nan)
                        acc[key] = x if k0 + k == 0 else acc[key] + x
                    if k0 + kn == bag:
                        res = (acc[key] / np.float32(bag) if mode == "mean"
                               else acc[key])
                        col = c0 + c + col_v[t] * W
                        out[b, col:col + W] = res
                        writes[b, col:col + W] += 1
    return out, writes


@pytest.mark.parametrize("name", list(MAIN_SHAPES))
def test_launch_plan_routes_the_main_path_shapes(name):
    """Every main-path shape takes 16-byte values and tiles of 8 bags with
    all their ids in one item, a whole 256-column row a part; the bulk
    calls (serve_bulk, a corpus chunk) and the small ones of 16 ids a bag
    (serve_p99, the query) one block a SM, the rest two; only the batch-1
    query (8 bags) is too small for the card and splits its columns into
    128-byte slabs, one block a slab."""
    n_bags, bag, D = MAIN_SHAPES[name]
    p = eb_ops.launch_plan(n_bags, bag, D, True)
    assert _plan_ok(p, n_bags, bag, D)
    assert (p.route, p.tile, p.chunk) == ("vec4", 8, bag)
    assert p.blocks == (1 if name in ("serve_bulk", "corpus chunk",
                                      "serve_p99", "retrieval query") else 2)
    if name == "retrieval query":
        assert (p.slab, p.parts, p.grid) == (eb_ops.MIN_SLAB, 8, 8)
    else:
        assert (p.slab, p.parts, p.grid) == (256, 1, eb_ops.SMS * p.blocks)
    # a table view off 16-byte alignment takes single floats
    assert eb_ops.launch_plan(n_bags, bag, D, False).route == "scalar"


@pytest.mark.parametrize("name", list(MAIN_SHAPES))
def test_launch_plan_visits_every_item_of_the_main_path_once(name):
    """The blocks' cursors visit each (tile, part) item exactly once, and the
    items' bag and column ranges tile the output."""
    n_bags, bag, D = MAIN_SHAPES[name]
    p = eb_ops.launch_plan(n_bags, bag, D, True)
    n_tiles = -(-n_bags // p.tile)
    seen = np.zeros((n_tiles, p.parts), np.int64)
    for _, tile, part, _ in _fills(p, n_bags, bag):
        seen[tile, part] += 1
    assert (seen == 1).all()
    assert (n_tiles - 1) * p.tile < n_bags <= n_tiles * p.tile
    assert (p.parts - 1) * p.slab < D <= p.parts * p.slab


@pytest.mark.parametrize("stage_bytes", [None, 4096])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("n_bags,bag,D,aligned,dups", [
    (8, 16, 256, True, "user"), (37, 16, 12, True, "item"),
    (33, 6, 7, True, "none"), (17, 5, 1, True, "none"),
    (40, 1, 33, True, "user"), (8, 40, 132, True, "none"),
    (3, 300, 16, True, "user"), (2, 600, 7, False, "none"),
    (20, 16, 64, False, "item"), (9, 8, 1024, True, "none"),
])
def test_launch_plan_walk_writes_each_cell_once_and_equals_plain(
        n_bags, bag, D, aligned, dups, mode, stage_bytes):
    """The kernel's arithmetic on the plan, in numpy: every (bag, column)
    written once, bitwise the plain version (NaN where it is NaN), with
    repeats inside and across bags, wrapped ids, -1 beside V - 1, and a
    repeated invalid id; bags of 300 and 600 span items; 4 KB stages split
    most items into narrower fills."""
    V = 50
    rng = np.random.default_rng(n_bags * bag + D)
    table = rng.standard_normal((V, D)).astype(np.float32)
    table[3, 0] = -0.0
    ids = rng.integers(-V, V, (n_bags, bag)).astype(np.int32)
    if dups == "user":                     # one id over a tile's slots
        ids[:] = ids[:, :1]
    elif dups == "item":                   # most slots one id a bag
        ids = np.where(rng.random(ids.shape) < 0.7, ids[:, :1], ids)
    if n_bags > 2 and bag > 2:
        ids[1, :2] = [-1, V - 1]           # one row, two ids
        ids[2, 0] = ids[2, -1] = V + 7     # a repeated invalid id
    p = _with_stage_bytes(eb_ops.launch_plan(n_bags, bag, D, aligned, sms=4),
                          n_bags, bag, D, stage_bytes)
    assert _plan_ok(p, n_bags, bag, D)
    got, writes = _walk(p, table, ids, mode)
    assert (writes == 1).all()
    want = embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(ids),
                             mode).numpy()
    same = (got.view(np.int32) == want.view(np.int32)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all()


@pytest.mark.parametrize("bag", [1, 2, 7, 8, 16, 31, 40, 128, 255, 256, 257,
                                 1000, 100000])
@pytest.mark.parametrize("D", [1, 3, 4, 129, 256, 1024, 4096, 1 << 20])
def test_launch_plan_limits(bag, D):
    """Shared memory within the card's 232,448 bytes a block, a grid under
    2^31, and every limit the kernel checks, from one bag to 2^33."""
    for n_bags in (1, 5, 8, 4096, 1 << 33):
        for aligned in (True, False):
            p = eb_ops.launch_plan(n_bags, bag, D, aligned)
            assert _plan_ok(p, n_bags, bag, D), p
            assert p.smem <= 232448 and p.grid < 2 ** 31
    with pytest.raises(ValueError):
        eb_ops.launch_plan(0, bag, D, True)
