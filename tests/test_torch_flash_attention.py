"""The flash-attention kernel's plain versions and its wrapper on CPU
tensors (``repro_torch.kernels.flash_attention``) against the reference
package: the JAX Pallas kernel in interpret mode (as ``tests/test_kernels.py``
runs it) and the JAX materialised oracle, on the same numpy inputs.

The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py``, marker ``cuda``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.kernels.flash_attention import (
    attention_np, attention_ref, flash_attention, flash_attention_ref,
)
from repro_torch.kernels.flash_attention.ref import (
    bf16_ulp_distance, within_one_bf16_ulp,
)

MASKS = [(True, None), (True, 64), (False, None)]


def _inputs(seed, B, Sq, Skv, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [(1, 128, 4, 4, 32),
                                          (2, 256, 8, 2, 64)])
def test_f32_matches_jax_kernel_in_interpret_mode(B, S, Hq, Hkv, D, causal,
                                                  window):
    q, k, v = _inputs(0, B, S, S, Hq, Hkv, D)
    want = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)), causal=causal,
                                window=window))
    reset_launches()
    got = flash_attention(*_t(q, k, v), causal=causal, window=window)
    assert not any(launch_counts().values())      # the CPU runs plain
    plain = flash_attention_ref(*_t(q, k, v), causal=causal, window=window)
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_bf16_matches_jax_kernel_in_interpret_mode():
    B, S, Hq, Hkv, D = 1, 256, 4, 2, 64
    q, k, v = _inputs(1, B, S, S, Hq, Hkv, D)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv).astype(jnp.float32))
    tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
    # the same bf16 inputs in both packages
    assert np.array_equal(tq.float().numpy(),
                          np.asarray(jq.astype(jnp.float32)))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)
    # the same float32 arithmetic, rounded once: within one bf16 ulp
    assert within_one_bf16_ulp(
        got, torch.from_numpy(np.array(want)).to(torch.bfloat16))


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D", [
    (1, 200, 200, 4, 2, 16),      # ragged: not a multiple of the block
    (1, 96, 200, 8, 2, 16),       # Sq < Skv
    (2, 200, 160, 4, 1, 8),       # Sq > Skv
    (1, 300, 300, 2, 2, 32),      # three blocks, the last short
])
def test_plain_versions_match_the_oracles(B, Sq, Skv, Hq, Hkv, D, causal,
                                          window):
    q, k, v = _inputs(2, B, Sq, Skv, Hq, Hkv, D)
    want = attention_np(q, k, v, causal, window)
    jax_want = np.asarray(jax_attention_ref(
        *map(jnp.asarray, (q, k, v)), causal=causal, window=window))
    np.testing.assert_allclose(want, jax_want, rtol=1e-5, atol=1e-5)
    mat = attention_ref(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(mat.numpy(), jax_want, rtol=2e-5, atol=2e-5)
    flash = flash_attention_ref(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(flash.numpy(), want, rtol=2e-5, atol=2e-5)
    if window is None or Sq <= Skv + window - 1:
        got = flash_attention(*_t(q, k, v), causal=causal, window=window)
        assert torch.equal(got, flash)


@pytest.mark.parametrize("kv_block", [32, 64, 100])
def test_plain_flash_does_not_depend_on_the_block(kv_block):
    q, k, v = _inputs(3, 1, 150, 150, 4, 2, 16)
    a = flash_attention_ref(*_t(q, k, v), window=40, kv_block=kv_block)
    b = flash_attention_ref(*_t(q, k, v), window=40)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-6, atol=2e-6)


def test_gqa_head_order():
    """Query head h reads KV head h // G, the reference's
    ``reshape(B, S, Hkv, G, D)`` order (not h % Hkv)."""
    B, S, Hq, Hkv, D = 1, 64, 6, 3, 8
    q, k, v = _inputs(4, B, S, S, Hq, Hkv, D)
    got = flash_attention(*_t(q, k, v)).numpy()
    G = Hq // Hkv
    for h in range(Hq):
        one = attention_np(q[:, :, h:h + 1], k[:, :, h // G:h // G + 1],
                           v[:, :, h // G:h // G + 1])
        np.testing.assert_allclose(got[:, :, h:h + 1], one, rtol=2e-5,
                                   atol=2e-5)
    other = attention_np(q[:, :, 1:2], k[:, :, 1:2], v[:, :, 1:2])
    assert np.abs(got[:, :, 1:2] - other).max() > 1e-2


def test_rows_without_keys_refused_and_plain_gives_the_mean_of_v():
    """Non-causal, window 4, Sq 20 > Skv 8: rows from Skv + window - 1 = 11
    on see no key. The reference returns the mean of v there (every p is
    exp(0) = 1); the plain versions do too; the wrapper refuses the shape
    on every device."""
    q, k, v = _inputs(5, 1, 20, 8, 4, 2, 8)
    want = np.asarray(jax_attention_ref(*map(jnp.asarray, (q, k, v)),
                                        causal=False, window=4))
    mean_v = np.repeat(v.mean(1, keepdims=True), 2, axis=2)   # (1, 1, 4, 8)
    np.testing.assert_allclose(want[:, 11:], np.broadcast_to(
        mean_v, want[:, 11:].shape), rtol=1e-5, atol=1e-5)
    for fn in (attention_ref, flash_attention_ref):
        got = fn(*_t(q, k, v), causal=False, window=4)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="no key"):
        flash_attention(*_t(q, k, v), causal=False, window=4)
    with pytest.raises(ValueError, match="no key"):
        flash_attention(*_t(q, k, v), window=0)


def test_wrapper_refuses_bad_inputs_on_cpu():
    q, k, v = _t(*_inputs(6, 1, 8, 8, 4, 2, 8))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="k and v"):
        flash_attention(q, k, v[..., :4].contiguous())
    with pytest.raises(TypeError):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="wants"):
        flash_attention(q[0], k, v)
    assert flash_attention(q[:, :0], k, v).shape == (1, 0, 4, 8)


def test_bf16_ulp_distance():
    a = torch.tensor([1.0, -1.0, 0.0, -0.0, 2.0, 1e-6], dtype=torch.bfloat16)
    b = torch.tensor([1.0078125, -1.0078125, -0.0, 0.0, 2.0, 2e-6],
                     dtype=torch.bfloat16)
    assert bf16_ulp_distance(a, b).tolist() == [1, 1, 0, 0, 0, 128]
    assert within_one_bf16_ulp(a, b)             # 1e-6 apart near 0
    assert not within_one_bf16_ulp(a[:1], -a[:1])


# The CUDA kernel's bf16 route multiplies P V on the tensor cores, which take
# P in bf16; the plain version (and the reference kernel) multiply a float32
# P. The kernel splits P into three bf16 terms. A test-local emulation of
# each choice (the plain version's loop with only the P V product changed)
# held to the plain version's 1-ulp check on the card tests' grid: three
# terms stay within it, one or two leave it.
FA_SHAPES = [(1, 128, 128, 4, 4, 32), (2, 256, 256, 8, 2, 64),
             (1, 512, 512, 4, 1, 128), (1, 200, 200, 4, 2, 128),
             (1, 96, 200, 8, 2, 64), (1, 200, 160, 4, 2, 64),
             (2, 40, 40, 8, 2, 8)]


def _flash_bf16_p(q, k, v, causal, window, terms: int):
    """``flash_attention_ref``'s arithmetic (128-key blocks, float32 scores,
    m, l and acc) with P V taken as the tensor cores take it: bf16 P times
    bf16 v, float32 sums. P is split into ``terms`` bf16 terms, each the
    rounding of what the ones before it leave of p (1: P rounded once),
    every term multiplied by v and summed into one float32 product."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, _ = v.shape
    G = Hq // Hkv
    qf = q.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4).reshape(
        B, Hkv, G * Sq, D)
    m = torch.full((B, Hkv, G, Sq), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, Sq, D))
    qpos = torch.arange(Sq)[:, None]
    for k0 in range(0, Skv, 128):
        k1 = min(k0 + 128, Skv)
        kb = k[:, k0:k1].float().permute(0, 2, 3, 1)
        vb = v[:, k0:k1].float().permute(0, 2, 1, 3)
        s = torch.matmul(qf, kb).view(B, Hkv, G, Sq, k1 - k0) * (1 / D ** 0.5)
        kpos = torch.arange(k0, k1)[None, :]
        keep = torch.ones((Sq, k1 - k0), dtype=torch.bool)
        if causal:
            keep &= qpos >= kpos
        if window is not None:
            keep &= qpos - kpos < window
        s = s.masked_fill(~keep, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        parts, rest = [], p
        for _ in range(terms):
            parts.append(rest.bfloat16().float())
            rest = rest - parts[-1]
        pv = sum(torch.matmul(t.view(B, Hkv, G * Sq, k1 - k0), vb)
                 for t in parts)
        acc = acc * corr[..., None] + pv.view(B, Hkv, G, Sq, D)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def _bf16_inputs(seed, shape):
    return [t.to(torch.bfloat16) for t in _t(*_inputs(seed, *shape))]


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("shape", FA_SHAPES)
def test_three_bf16_terms_of_p_within_one_ulp_of_plain(shape, causal, window):
    B, Sq, Skv, Hq, Hkv, D = shape
    if window is not None and Sq > Skv + window - 1:
        pytest.skip("a row with no key: refused by the wrapper")
    q, k, v = _bf16_inputs(7, shape)
    plain = flash_attention_ref(q, k, v, causal, window)
    got = _flash_bf16_p(q, k, v, causal, window, terms=3)
    assert within_one_bf16_ulp(got, plain)


@pytest.mark.parametrize("terms", [1, 2])
def test_fewer_bf16_terms_of_p_miss_one_ulp_of_plain(terms):
    """The controls: P rounded once to bf16 (as SDPA's flash kernel takes
    it), or split in two terms, leaves the 1-ulp check somewhere on the
    grid (two terms: at outputs near 0, where a term's rounding, up to
    2^-18 of p, is more than an ulp and 1e-6)."""
    missed = 0
    for shape in FA_SHAPES:
        for causal, window in MASKS:
            if window is not None and shape[1] > shape[2] + window - 1:
                continue
            q, k, v = _bf16_inputs(7, shape)
            got = _flash_bf16_p(q, k, v, causal, window, terms)
            missed += not within_one_bf16_ulp(
                got, flash_attention_ref(q, k, v, causal, window))
    assert missed >= 1
