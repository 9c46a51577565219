"""The port's MoE FFN (``repro_torch.models.lm.moe``) against the
reference's ``moe_ffn`` on the CPU: the same numpy weights and tokens, the
values, the aux loss and the gradients (of the tokens and of every leaf)
within 1e-5 in float32, at the default capacity, at a capacity tight
enough to drop assignments, at a token count the group count does not
divide, and with shared experts; and two calls bitwise equal."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.lm import moe as jax_moe
from repro_torch.models.lm import moe

TOL = 1e-5


def _cfgs(**kw):
    base = dict(n_experts=4, top_k=2, d_ff_expert=24, groups=4)
    base.update(kw)
    return jax_moe.MoEConfig(**base), moe.MoEConfig(**base)


def _inputs(jcfg, T, d=16, seed=0):
    params = jax.tree.map(np.asarray, jax_moe.init_moe_params(
        jax.random.PRNGKey(seed), d, jcfg))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = rng.standard_normal((T, d)).astype(np.float32)
    return params, x, w


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _reference(params, x, w, jcfg, aux_weight=3.0):
    def f(p, x):
        y, aux = jax_moe.moe_ffn(p, x, jcfg)
        return jnp.sum(y * w) + aux_weight * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return np.asarray(y), float(aux), jax.tree.map(np.asarray, gp), \
        np.asarray(gx)


def _dropped(router, x, mcfg) -> int:
    """The assignments past capacity: each group's per-expert counts of
    the top-k picks of ``x @ router``, counted independently of
    ``moe_ffn``'s queue positions."""
    T, d = x.shape
    G, C = moe.moe_shape(mcfg, T)
    logits = (x.reshape(G, T // G, d) @ router).numpy()
    topi = np.argsort(-logits, axis=-1)[..., :mcfg.top_k].reshape(G, -1)
    per = np.stack([np.bincount(t, minlength=mcfg.n_experts) for t in topi])
    return int(np.maximum(per - C, 0).sum())


def _port(params, x, w, tcfg, aux_weight=3.0):
    p = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
         for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = moe.moe_ffn(types.SimpleNamespace(**p), xt, tcfg)
    loss = (y * torch.from_numpy(w)).sum() + aux_weight * aux
    grads = torch.autograd.grad(loss, [xt, *p.values()])
    return y.detach(), aux.detach(), dict(zip(p, grads[1:])), grads[0]


CASES = {
    "default": (dict(), 64),
    "tight": (dict(capacity_factor=0.25), 64),
    "ragged_groups": (dict(), 30),                       # G = 3
    "shared": (dict(n_shared=2, top_k=3, n_experts=6), 48),
    "one_group": (dict(groups=1, capacity_factor=0.5), 40),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_values_aux_and_gradients_match_jax(case):
    kw, T = CASES[case]
    jcfg, tcfg = _cfgs(**kw)
    params, x, w = _inputs(jcfg, T)
    y, aux, gp, gx = _reference(params, x, w, jcfg)
    ty, taux, tgp, tgx = _port(params, x, w, tcfg)
    assert ty.dtype == torch.float32 and taux.dtype == torch.float32
    assert _max_rel(y, ty.numpy()) <= TOL
    assert abs(float(taux) - aux) <= TOL * max(abs(aux), 1.0)
    assert _max_rel(gx, tgx.numpy()) <= TOL
    assert set(tgp) == set(gp)
    for k in gp:
        assert _max_rel(gp[k], tgp[k].numpy()) <= TOL, k
    if case in ("tight", "one_group"):
        # the capacity really drops assignments
        assert _dropped(torch.from_numpy(np.array(params["router"])),
                        torch.from_numpy(x), tcfg) > 0


def test_group_split_and_capacity_are_the_references():
    mcfg = moe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=4)
    assert moe.moe_shape(mcfg, 30) == (30, 4)            # G = min(32, T)
    assert moe.moe_shape(dataclasses.replace(mcfg, groups=4), 30) == (3, 4)
    assert moe.moe_shape(mcfg, 32768) == (32, 320)       # Mixtral prefill
    ds = moe.MoEConfig(n_experts=160, top_k=6, d_ff_expert=4)
    assert moe.moe_shape(ds, 32768) == (32, 48)
    assert moe.moe_shape(ds, 4) == (4, 4)                # decode, batch 4
    assert moe.moe_shape(mcfg, 64) == (32, 4)            # 2 tokens a group


def test_init_leaves_shapes_and_dtypes_are_the_references():
    jcfg, tcfg = _cfgs(n_shared=2)
    ref = jax.eval_shape(lambda k: jax_moe.init_moe_params(
        k, 16, dataclasses.replace(jcfg)), jax.random.PRNGKey(0))
    shapes = moe.moe_param_shapes(16, tcfg)
    assert list(shapes) == ["router", "w_gate", "w_up", "w_down",
                            "shared_gate", "shared_up", "shared_down"]
    assert {k: tuple(v.shape) for k, v in ref.items()} == shapes
    assert tcfg.d_ff_shared_total == 2 * 24
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_two_calls_are_bitwise_equal():
    jcfg, tcfg = _cfgs(capacity_factor=0.5, n_shared=1)
    params, x, w = _inputs(jcfg, 64, seed=3)
    a, b = (_port(params, x, w, tcfg) for _ in range(2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[3], b[3])
    assert all(torch.equal(a[2][k], b[2][k]) for k in a[2])


def test_bf16_tokens_keep_a_float32_router():
    """bf16 tokens and experts, the router float32 (the reference's
    leaves): the output is bf16, the aux float32, within bf16 rounding of
    the reference's."""
    jcfg, tcfg = _cfgs()
    params, x, _ = _inputs(jcfg, 64, seed=4)
    jp = {k: (v if k == "router" else jnp.asarray(v).astype(jnp.bfloat16))
          for k, v in params.items()}
    y, aux = jax.jit(lambda p, x: jax_moe.moe_ffn(p, x, jcfg))(
        jp, jnp.asarray(x).astype(jnp.bfloat16))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    tp = {k: (v if k == "router" else v.to(torch.bfloat16))
          for k, v in tp.items()}
    ty, taux = moe.moe_ffn(types.SimpleNamespace(**tp),
                           torch.from_numpy(x).to(torch.bfloat16), tcfg)
    assert ty.dtype == torch.bfloat16 and taux.dtype == torch.float32
    assert _max_rel(np.asarray(y.astype(jnp.float32)),
                    ty.float().numpy()) <= 2e-2
    assert abs(float(taux) - float(aux)) <= 1e-5


def test_given_experts_equal_to_the_top_k_change_nothing():
    """``experts`` set to the tokens' own top k (in ``topk``'s order):
    the output, the aux and the gradients bitwise the unforced call's,
    drops included."""
    jcfg, tcfg = _cfgs(capacity_factor=0.5, n_shared=1)
    params, x, _ = _inputs(jcfg, 64, seed=5)
    p = types.SimpleNamespace(**{k: torch.from_numpy(np.array(v))
                                 for k, v in params.items()})
    xt = torch.from_numpy(x)
    top = torch.topk((xt.reshape(4, 16, -1) @ p.router), tcfg.top_k,
                     dim=-1)[1].reshape(64, -1)
    a, b = moe.moe_ffn(p, xt, tcfg), moe.moe_ffn(p, xt, tcfg, experts=top)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_given_experts_route_each_token_there():
    """Random distinct experts a token, capacity enough for all: each
    token's output is the softmax of its router logits at those experts
    weighting their SwiGLU outputs, in float64 numpy, within 1e-5."""
    jcfg, tcfg = _cfgs(capacity_factor=8.0, n_experts=6, top_k=3)
    T = 24
    params, x, _ = _inputs(jcfg, T, seed=6)
    rng = np.random.default_rng(6)
    ex = np.stack([rng.permutation(6)[:3] for _ in range(T)])
    p = types.SimpleNamespace(**{k: torch.from_numpy(np.array(v))
                                 for k, v in params.items()})
    y, _ = moe.moe_ffn(p, torch.from_numpy(x), tcfg,
                       experts=torch.from_numpy(ex))
    P = {k: np.asarray(v, np.float64) for k, v in params.items()}
    xd = x.astype(np.float64)
    want = np.zeros_like(xd)
    for t in range(T):
        lg = xd[t] @ P["router"][:, ex[t]]
        g = np.exp(lg - lg.max())
        g /= g.sum()
        for j, e in enumerate(ex[t]):
            h = xd[t] @ P["w_gate"][e]
            h = h / (1 + np.exp(-h)) * (xd[t] @ P["w_up"][e])
            want[t] += g[j] * (h @ P["w_down"][e])
    assert _max_rel(want, y.numpy()) <= TOL
