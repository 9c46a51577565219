"""The port's dense-LM training (``lm_loss``, per-layer remat, the
checkpointed ``chunked_attention``, ``make_train_step`` with the in-place
AdamW) against the reference package on the CPU, on the same numpy
weights and tokens.

The reference's ``jax.value_and_grad(lm_loss)`` and its
``make_train_step`` step (on a ``(1, 1)`` mesh, called unjitted) run as
its own tests run them; the port runs with ``device="cpu"``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import command_r_plus_104b as j_cr
from repro.configs import deepseek_67b as j_ds
from repro.configs import phi3_medium_14b as j_phi
from repro.models.lm import steps as jax_steps
from repro.models.lm import transformer as jax_tf
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro_torch.configs import command_r_plus_104b as t_cr
from repro_torch.configs import deepseek_67b as t_ds
from repro_torch.configs import phi3_medium_14b as t_phi
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.lm.attention import attention, chunked_attention
from repro_torch.models.lm.steps import make_train_step
from repro_torch.models.lm.transformer import (
    LMConfig, init_lm_params, lm_value_and_grad,
)
from repro_torch.optim import adamw_init, adamw_update, adamw_update_
from repro_torch.params import lm_from_jax, lm_grads_to_jax, lm_to_numpy

SMOKES = {"phi3-medium-14b": (j_phi.SMOKE, t_phi.SMOKE),
          "command-r-plus-104b": (j_cr.SMOKE, t_cr.SMOKE),
          "deepseek-67b": (j_ds.SMOKE, t_ds.SMOKE)}
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4           # max |a - b| / max |a|, a gradient
STEP_TOL = 1e-5           # assert_allclose rtol = atol: parameters, m, v


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _reference(name, seed=0):
    """The reference's SMOKE params (JAX key ``seed``) and the port's model
    made from them."""
    jcfg, tcfg = SMOKES[name]
    params = _np(jax_tf.init_lm_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, params, lm_from_jax(params, tcfg, "cpu")


@pytest.mark.parametrize("name", list(SMOKES))
def test_lm_loss_and_gradients_match_jax(name):
    jcfg, tcfg, params, model = _reference(name)
    toks = _tokens(0, 2, 32, jcfg.vocab)
    (loss, (ce, aux)), grads = jax.value_and_grad(
        lambda p: jax_tf.lm_loss(p, jnp.asarray(toks), jcfg), has_aux=True
    )(params)
    (tloss, (tce, taux)), tgrads = lm_value_and_grad(
        model, torch.from_numpy(toks))
    assert abs(float(tloss) - float(loss)) <= LOSS_TOL
    assert abs(float(tce) - float(ce)) <= LOSS_TOL
    assert taux == float(aux) == 0.0
    assert list(tgrads) == [n for n, _ in model.named_parameters()]
    assert all(g.dtype == torch.float32 for g in tgrads.values())
    got = lm_grads_to_jax(tgrads)
    assert jax.tree.structure(got) == jax.tree.structure(_np(grads))
    errs = jax.tree.map(_max_rel, _np(grads), got)
    assert max(jax.tree.leaves(errs)) <= GRAD_TOL, errs
    # the model's parameters ask for no gradient outside the call
    assert not any(p.requires_grad for p in model.parameters())


def test_train_steps_match_the_reference_step():
    """One and three steps of ``make_train_step`` against the reference's
    train step on a (1, 1) mesh: parameters, ``m`` and ``v`` within
    ``STEP_TOL`` (``assert_allclose``, rtol = atol). At step 1 AdamW
    moves each weight by ``lr * g / (|g| + eps)``: where a gradient nearly
    cancels (|g| ~ 1e-8 of a leaf whose largest is 1e-2), the two
    frameworks' float32 sums give it other signs and that weight moves
    up to ``lr`` apart (1.02e-5 measured on ``lm_head``)."""
    jcfg, tcfg, params, model = _reference("phi3-medium-14b")
    toks = _tokens(0, 2, 32, jcfg.vocab)
    jstep = jax_steps.make_train_step(
        jcfg, jax.make_mesh((1, 1), ("data", "model")))[0]
    jparams, jopt = params, jax_adamw_init(params)
    step, (pshard, oshard), pshard2, oshard2 = make_train_step(
        tcfg, device="cpu")
    assert pshard is oshard is pshard2 is oshard2 is None
    opt = adamw_init(model)
    for i in range(1, 4):
        jparams, jopt, jm = jstep(jparams, jopt, jnp.asarray(toks))
        out, opt_out, m = step(model, opt, torch.from_numpy(toks))
        assert out is model and opt_out is opt            # in place
        assert set(m) == {"loss", "ce", "aux"}
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL
        assert int(opt["step"]) == int(jopt["step"]) == i
        if i in (1, 3):
            for want, got in ((jparams, lm_to_numpy(model)),
                              (jopt["m"], lm_grads_to_jax(opt["m"])),
                              (jopt["v"], lm_grads_to_jax(opt["v"]))):
                jax.tree.map(lambda a, b: np.testing.assert_allclose(
                    b, np.asarray(a), rtol=STEP_TOL, atol=STEP_TOL),
                    _np(want), got)


def test_remat_on_equals_off_bitwise():
    toks = torch.from_numpy(_tokens(1, 2, 48, t_phi.SMOKE.vocab))
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(t_phi.SMOKE, remat=remat)
        model = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
        out[remat] = lm_value_and_grad(model, toks)
    (a, ga), (b, gb) = out[True], out[False]
    assert torch.equal(a[0], b[0]) and torch.equal(a[1][0], b[1][0])
    assert ga.keys() == gb.keys()
    assert all(torch.equal(ga[k], gb[k]) for k in ga)


@pytest.mark.parametrize("window", [None, 24])
def test_checkpointed_chunked_attention_gradients_are_autograds(window):
    """Each KV step under ``torch.utils.checkpoint`` (the reference's
    ``@jax.checkpoint``): output and q, k, v gradients bitwise the
    uncheckpointed pass's, and the output bitwise the no-grad one's."""
    rng = np.random.default_rng(2)
    q, k, v, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16),
                            (2, 64, 4, 16)))
    got = {}
    for ck in (True, False):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = chunked_attention(*qkv, window=window, q_chunk=16, kv_chunk=16,
                              kv_checkpoint=ck)
        got[ck] = (o.detach(), *torch.autograd.grad((o * w).sum(), qkv))
    assert all(torch.equal(x, y) for x, y in zip(got[True], got[False]))
    with torch.no_grad():
        plain = chunked_attention(q, k, v, window=window, q_chunk=16,
                                  kv_chunk=16)
    assert torch.equal(plain, got[True][0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_update_in_place_equals_functional_bitwise(dtype):
    gen = torch.Generator().manual_seed(3)

    def tree():
        return {"a": torch.randn(37, 19, generator=gen).to(dtype),
                "b": [torch.randn(1001, generator=gen).to(dtype)]}

    p = tree()
    q = {"a": p["a"].clone(), "b": [p["b"][0].clone()]}
    so, si = adamw_init(p), adamw_init(q)
    for wd in (0.0, 0.1, 0.0):
        g = tree()
        p, so = adamw_update(g, p, so, lr=1e-2, weight_decay=wd)
        q2, si2 = adamw_update_(g, q, si, lr=1e-2, weight_decay=wd)
        assert q2 is q and si2 is si
        for x, y in ((p["a"], q["a"]), (p["b"][0], q["b"][0]),
                     (so["m"]["a"], si["m"]["a"]),
                     (so["v"]["b"][0], si["v"]["b"][0])):
            assert x.dtype == y.dtype and torch.equal(x, y)
        assert torch.equal(so["step"], si["step"])


def test_loss_decreases():
    """The reference's ``TestTraining.test_loss_decreases`` on the port:
    12 steps at lr 3e-3 on one batch of 4 x 32 tokens, its config."""
    cfg = LMConfig(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                   d_head=8, d_ff=64, vocab=128, dtype=torch.float32,
                   q_chunk=8, kv_chunk=8, remat=False)
    model = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = adamw_init(model)
    toks = torch.from_numpy(_tokens(1, 4, 32, cfg.vocab))
    step = make_train_step(cfg, lr=3e-3, device="cpu")[0]
    losses = []
    for _ in range(12):
        model, opt, m = step(model, opt, toks)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3


def test_flash_attention_refuses_gradient_requiring_inputs_on_the_cpu():
    """The kernel is forward-only: under grad mode, inputs that require
    grad are refused on every device (on the card its output would carry
    no gradient); under ``no_grad`` or without ``requires_grad`` it runs."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 32, 4, 8), (1, 32, 2, 8), (1, 32, 2, 8)))
    for i in range(3):
        args = [t.clone().requires_grad_(j == i) for j, t in
                enumerate((q, k, v))]
        with pytest.raises(RuntimeError, match="forward-only"):
            flash_attention(*args)
        with pytest.raises(RuntimeError, match="forward-only"):
            attention(*args, kernels="kernel")
        with torch.no_grad():
            assert torch.equal(flash_attention(*args),
                               flash_attention(q, k, v))
    assert not flash_attention(q, k, v).requires_grad


# ------------------------------------------------------------------ MoE, MLA

from repro.configs import deepseek_v2_236b as j_dv2  # noqa: E402
from repro.configs import mixtral_8x7b as j_mx  # noqa: E402
from repro_torch.configs import deepseek_v2_236b as t_dv2  # noqa: E402
from repro_torch.configs import mixtral_8x7b as t_mx  # noqa: E402

MOE_SMOKES = {"mixtral-8x7b": (j_mx.SMOKE, t_mx.SMOKE),
              "deepseek-v2-236b": (j_dv2.SMOKE, t_dv2.SMOKE)}


def _moe_reference(name, seed=0):
    jcfg, tcfg = MOE_SMOKES[name]
    params = _np(jax.jit(lambda k: jax_tf.init_lm_params(k, jcfg))(
        jax.random.PRNGKey(seed)))
    return jcfg, tcfg, params, lm_from_jax(params, tcfg, "cpu")


@pytest.mark.parametrize("name", list(MOE_SMOKES))
def test_moe_lm_loss_and_gradients_match_jax(name):
    """``lm_loss`` (cross-entropy plus 0.01 x the MoE aux) and every
    gradient, the routers' and the dense layer's included, against
    ``jax.value_and_grad(lm_loss)``."""
    jcfg, tcfg, params, model = _moe_reference(name)
    toks = _tokens(0, 2, 32, jcfg.vocab)
    (loss, (ce, aux)), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_tf.lm_loss(p, jnp.asarray(toks), jcfg),
        has_aux=True))(params)
    (tloss, (tce, taux)), tgrads = lm_value_and_grad(
        model, torch.from_numpy(toks))
    assert abs(float(tloss) - float(loss)) <= LOSS_TOL
    assert abs(float(tce) - float(ce)) <= LOSS_TOL
    assert abs(float(taux) - float(aux)) <= LOSS_TOL and float(aux) > 0
    assert not taux.requires_grad
    got = lm_grads_to_jax(tgrads)
    assert jax.tree.structure(got) == jax.tree.structure(_np(grads))
    errs = jax.tree.map(_max_rel, _np(grads), got)
    assert max(jax.tree.leaves(errs)) <= GRAD_TOL, errs
    assert tgrads["layers.0.router"].dtype == torch.float32


@pytest.mark.parametrize("name", list(MOE_SMOKES))
def test_moe_remat_on_equals_off_bitwise(name):
    """Remat on and off, and two calls: the loss, the aux and every
    gradient bitwise (no float atomics in the MoE FFN)."""
    toks = torch.from_numpy(_tokens(1, 2, 48, 256))
    out = []
    for remat in (True, False, True):
        cfg = dataclasses.replace(MOE_SMOKES[name][1], remat=remat)
        model = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
        out.append(lm_value_and_grad(model, toks))
    (a, ga) = out[0]
    for b, gb in out[1:]:
        assert torch.equal(a[0], b[0]) and torch.equal(a[1][1], b[1][1])
        assert ga.keys() == gb.keys()
        assert all(torch.equal(ga[k], gb[k]) for k in ga)


def test_moe_train_steps_match_the_reference_step():
    """Two steps of ``make_train_step`` on DeepSeek-V2's ``SMOKE`` (MLA,
    shared experts, a dense first layer) against the reference's train
    step on a (1, 1) mesh: loss, parameters, ``m`` and ``v``."""
    jcfg, tcfg, params, model = _moe_reference("deepseek-v2-236b", seed=2)
    toks = _tokens(3, 2, 32, jcfg.vocab)
    jstep = jax.jit(jax_steps.make_train_step(
        jcfg, jax.make_mesh((1, 1), ("data", "model")))[0])
    jparams, jopt = params, jax_adamw_init(params)
    step = make_train_step(tcfg, device="cpu")[0]
    opt = adamw_init(model)
    for _ in range(2):
        jparams, jopt, jm = jstep(jparams, jopt, jnp.asarray(toks))
        _, _, m = step(model, opt, torch.from_numpy(toks))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL
        assert abs(float(m["aux"]) - float(jm["aux"])) <= LOSS_TOL
    for want, got in ((jparams, lm_to_numpy(model)),
                      (jopt["m"], lm_grads_to_jax(opt["m"])),
                      (jopt["v"], lm_grads_to_jax(opt["v"]))):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            b, np.asarray(a), rtol=STEP_TOL, atol=STEP_TOL),
            _np(want), got)
