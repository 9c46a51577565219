"""The CUDA kernels (gather/scatter, edge softmax) on the card, against the
numpy oracles.

Marked ``cuda``: they skip where there is no CUDA device (the kernels have
no CPU mode; the CPU tests cover the plain versions). This file imports
nothing of JAX, so it also runs on a machine without it::

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.edge_softmax import ops as es_ops
from repro_torch.kernels.edge_softmax import ref as es_ref
from repro_torch.kernels.gather_scatter import ops, ref


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
