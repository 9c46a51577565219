"""The port's PowerSGD compression with error feedback
(``repro_torch.optim.compression``) against the reference's
(``repro.optim.compression``) on the CPU.

The random starts cannot equal JAX's (a seeded ``torch.Generator`` per
leaf takes the place of ``fold_in``), so the tests hold the properties the
reference's own tests hold, the byte counts against the reference's on the
same tree, and the pass-through leaves bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.compression import compress_decompress as jax_compress
from repro.optim.compression import compress_init as jax_compress_init
from repro_torch.optim.compression import compress_decompress, compress_init


def test_compression_error_feedback_converges():
    """The reference's test on the port: SGD on a quadratic with rank-2
    compressed gradients and error feedback still converges; the matrix
    (64 x 128 > 4,096 elements) is large enough that compression
    engages."""
    rng = np.random.default_rng(1)
    target = torch.from_numpy(rng.standard_normal((64, 128)).astype(
        np.float32))
    w = {"w": torch.zeros(64, 128)}
    state = compress_init(w)
    losses = []
    for i in range(600):
        g = {"w": 2 * (w["w"] - target)}
        gc, state, stats = compress_decompress(g, state, rank=2, seed=i)
        # EF-SGD needs a conservative lr (Vogels et al. 2019, section 4)
        w = {"w": w["w"] - 0.02 * gc["w"]}
        losses.append(float(((w["w"] - target) ** 2).mean()))
    assert stats["ratio"] > 3.0            # compression really engaged
    assert losses[-1] < 1e-6 * losses[0]   # and convergence survived


def test_compression_unbiased_long_run():
    """The reference's test on the port: the decompressed gradients plus
    the final error sum to the true gradients."""
    rng = np.random.default_rng(2)
    g_seq = [{"w": torch.from_numpy(rng.standard_normal((16, 64)).astype(
        np.float32))} for _ in range(10)]
    state = compress_init(g_seq[0])
    total_dec = torch.zeros(16, 64)
    for i, g in enumerate(g_seq):
        dec, state, _ = compress_decompress(g, state, rank=2, seed=i)
        total_dec = total_dec + dec["w"]
    total_true = sum(g["w"] for g in g_seq)
    np.testing.assert_allclose((total_dec + state["error"]["w"]).numpy(),
                               total_true.numpy(), rtol=1e-3, atol=1e-3)


# leaves of every kind: a scalar, a vector, a small matrix, a matrix with a
# side of at most 2 * rank, a 3-d leaf, and two that compress
_SHAPES = {"s": (), "b": (300,), "small": (32, 64), "thin": (4096, 8),
           "t3": (8, 16, 64), "w": (96, 128), "head": (64, 200)}


def _trees(seed):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in _SHAPES.items()}


@pytest.mark.parametrize("rank", [2, 4])
def test_byte_counts_equal_the_references(rank):
    g = _trees(0)
    _, _, want = jax_compress({k: jnp.asarray(v) for k, v in g.items()},
                              jax_compress_init(g), rank=rank)
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    _, _, got = compress_decompress(tg, compress_init(tg), rank=rank)
    assert got == {k: float(v) for k, v in want.items()}
    assert got["ratio"] > 1.0


def test_pass_through_leaves_are_g_plus_e_bitwise():
    """Leaves with fewer than 4,096 elements or a side of at most
    ``2 * rank`` come back as ``g + e`` in ``g``'s dtype with a zero error;
    the others come back as a rank-``r`` product whose error is the rest
    (in float32: bf16 rounds the product), with a float32 error whatever
    ``g``'s dtype."""
    rank = 4
    g = {k: torch.from_numpy(v) for k, v in _trees(1).items()}
    g["bf"] = torch.from_numpy(_trees(2)["small"]).to(torch.bfloat16)
    g["bfw"] = torch.from_numpy(_trees(3)["w"]).to(torch.bfloat16)
    state = compress_init(g)
    # a first step leaves an error where the leaf compresses
    _, state, _ = compress_decompress(g, state, rank=rank, seed=5)
    g2 = {k: (v * 0.5).to(v.dtype) for k, v in g.items()}
    out, new, _ = compress_decompress(g2, state, rank=rank, seed=6)
    passed = {"s", "b", "small", "thin", "bf"}
    for k, v in g2.items():
        e = state["error"][k]
        assert out[k].dtype == v.dtype and out[k].shape == v.shape
        assert new["error"][k].dtype == torch.float32
        if k in passed:
            assert not e.any()                      # no error carried in
            assert torch.equal(out[k], (v.float() + e).to(v.dtype))
            assert not new["error"][k].any()
        else:
            m = (v.float() + e).reshape(-1, v.shape[-1])
            assert e.any() and new["error"][k].any()
            rebuilt = out[k].float().reshape(m.shape) + \
                new["error"][k].reshape(m.shape)
            if v.dtype == torch.float32:       # bf16 rounds the product
                np.testing.assert_allclose(rebuilt.numpy(), m.numpy(),
                                           rtol=1e-5, atol=1e-5)
                assert torch.linalg.matrix_rank(out[k].reshape(m.shape)) \
                    <= rank


def test_draws_depend_on_the_seed_and_the_leaf_only():
    g = {k: torch.from_numpy(v) for k, v in _trees(4).items()}
    a, _, _ = compress_decompress(g, compress_init(g), seed=7)
    b, _, _ = compress_decompress(g, compress_init(g), seed=7)
    c, _, _ = compress_decompress(g, compress_init(g), seed=8)
    assert all(torch.equal(a[k], b[k]) for k in g)
    assert not torch.equal(a["w"], c["w"])
    with pytest.raises(ValueError, match="leaves"):
        compress_decompress(g, {"error": {"w": torch.zeros(96, 128)}})
