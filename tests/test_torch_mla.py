"""The port's MLA attention (``mla_train_attention``,
``mla_decode_attention`` in ``repro_torch.models.lm.attention``) against
the reference's on the CPU, at DeepSeek-V2's ``SMOKE`` widths in float32
with the reference's weights: training's output and its gradients (of
the tokens and of every MLA leaf) within 1e-5, the absorbed decode with
equal caches (its output and the cache rows it writes), and the absorbed
decode against the materialised prefill, position by position."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.deepseek_v2_236b import SMOKE as JAX_SMOKE
from repro.models.lm import attention as jax_attn
from repro.models.lm import transformer as jax_tf
from repro_torch.configs.deepseek_v2_236b import SMOKE
from repro_torch.models.lm import attention

TOL = 1e-5


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _params(seed=0):
    """The reference's MLA leaves (float32, its ``_init_attn``) as numpy,
    with the norms drawn too (ones would hide a misplaced norm)."""
    p = jax.tree.map(np.asarray, jax_tf._init_attn(
        jax.random.PRNGKey(seed), JAX_SMOKE, jnp.float32))
    rng = np.random.default_rng(seed + 100)
    for k in ("q_norm", "kv_norm"):
        p[k] = (1 + 0.3 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p


def _ns(p, grad=False):
    return types.SimpleNamespace(**{
        k: torch.from_numpy(np.array(v)).requires_grad_(grad)
        for k, v in p.items()})


def _x(seed, B, S):
    return np.random.default_rng(seed).standard_normal(
        (B, S, SMOKE.d_model)).astype(np.float32)


@pytest.mark.parametrize("S", [32, 48])
def test_mla_train_attention_and_gradients_match_jax(S):
    p, B = _params(), 2
    x, w = _x(1, B, S), np.random.default_rng(2).standard_normal(
        (B, S, SMOKE.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)

    def f(p, x):
        o = jax_attn.mla_train_attention(p, x, jnp.asarray(pos), JAX_SMOKE,
                                         q_chunk=16, kv_chunk=16)
        return jnp.sum(o * w), o

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    tp = _ns(p, grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = attention.mla_train_attention(tp, xt, torch.from_numpy(pos), SMOKE,
                                        q_chunk=16, kv_chunk=16)
    assert got.shape == (B, S, SMOKE.d_model)
    assert _max_rel(want, got.detach().numpy()) <= TOL
    names = list(p)
    grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(),
                                [xt] + [getattr(tp, k) for k in names])
    assert _max_rel(gx, grads[0].numpy()) <= TOL
    for k, g in zip(names, grads[1:]):
        assert _max_rel(gp[k], g.numpy()) <= TOL, k


@pytest.mark.parametrize("cache_len", [1, 9, 24])
def test_mla_decode_attention_matches_jax_with_equal_caches(cache_len):
    p, B, S = _params(seed=3), 3, 24
    rng = np.random.default_rng(4)
    x = _x(5, B, 1)
    ckv = rng.standard_normal((B, S, SMOKE.kv_lora)).astype(np.float32)
    kr = rng.standard_normal((B, S, SMOKE.qk_rope_dim)).astype(np.float32)
    want, jckv, jkr = jax_attn.mla_decode_attention(
        p, jnp.asarray(x), jnp.asarray(ckv), jnp.asarray(kr),
        jnp.int32(cache_len), JAX_SMOKE)
    tckv, tkr = torch.from_numpy(ckv.copy()), torch.from_numpy(kr.copy())
    got = attention.mla_decode_attention(_ns(p), torch.from_numpy(x), tckv,
                                         tkr, cache_len, SMOKE)
    assert _max_rel(want, got.numpy()) <= TOL
    np.testing.assert_allclose(tckv.numpy(), np.asarray(jckv), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr), rtol=TOL,
                               atol=TOL)
    # only the new position was written, in place
    keep = np.arange(S) != cache_len - 1
    assert np.array_equal(tckv.numpy()[:, keep], ckv[:, keep])
    assert np.array_equal(tkr.numpy()[:, keep], kr[:, keep])


@pytest.mark.parametrize("seed", [6, 8])
def test_absorbed_decode_equals_materialised_prefill(seed):
    """Token by token through the latent caches, each position's output
    against the materialised attention's over the whole prompt, in
    float32: the absorbed form is the same function, only summed in
    another order."""
    cfg = SMOKE
    p = _ns(_params(seed=seed))
    B, S = 2, 32
    x = torch.from_numpy(_x(seed + 1, B, S))
    pos = torch.arange(S).expand(B, S)
    full = attention.mla_train_attention(p, x, pos, cfg, q_chunk=16,
                                         kv_chunk=16)
    ckv = torch.zeros((B, S, cfg.kv_lora))
    kr = torch.zeros((B, S, cfg.qk_rope_dim))
    dec = torch.cat([attention.mla_decode_attention(
        p, x[:, t:t + 1], ckv, kr, t + 1, cfg) for t in range(S)], dim=1)
    err = float((dec - full).abs().max() / full.abs().max())
    assert err <= 2e-5, err
