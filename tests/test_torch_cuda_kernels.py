"""The CUDA gather kernels on the card, against the numpy oracles.

Marked ``cuda``: they skip where there is no CUDA device (the kernels have
no CPU mode; the CPU tests cover the plain versions). This file imports
nothing of JAX, so it also runs on a machine without it::

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

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
