"""The port's dense LM (``repro_torch.models.lm``, ``configs``, the LM
converters in ``params``, the launcher's LM branch) against the reference
package on the CPU, on the same numpy inputs and converted weights.

The JAX functions run as the JAX tests run them; the port runs with
``device="cpu"``, so its ``flash_attention`` wrapper takes the kernel's
plain version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs.phi3_medium_14b import CONFIG as JAX_CONFIG
from repro.configs.phi3_medium_14b import SMOKE as JAX_SMOKE
from repro.models.lm import attention as jax_attn
from repro.models.lm import layers as jax_layers
from repro.models.lm import transformer as jax_tf
from repro_torch.configs import base
from repro_torch.configs.phi3_medium_14b import CONFIG, SMOKE
from repro_torch.kernels import launch_counts, reset_launches
from repro_torch.models.lm import attention, layers, transformer
from repro_torch.models.lm.steps import make_decode_step, make_prefill_step
from repro_torch.params import lm_from_jax, lm_to_numpy


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jax_cfg(**kw):
    return dataclasses.replace(JAX_SMOKE, **kw)


def _port_cfg(**kw):
    return dataclasses.replace(SMOKE, **kw)


def _models(seed=0, jkw=None, tkw=None):
    """The reference's SMOKE params (JAX key ``seed``) and the port's
    model made from them."""
    jcfg, tcfg = _jax_cfg(**(jkw or {})), _port_cfg(**(tkw or {}))
    params = _np(jax_tf.init_lm_params(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, params, lm_from_jax(params, tcfg, "cpu")


def _tokens(seed, B, S, vocab=SMOKE.vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


# ------------------------------------------------------------------ config

def test_config_counts_equal_the_reference():
    assert CONFIG.param_count() == JAX_CONFIG.param_count() == 14_659_502_080
    assert CONFIG.active_param_count() == JAX_CONFIG.active_param_count()
    assert SMOKE.param_count() == JAX_SMOKE.param_count()
    assert base.LM_SHAPES == jax_base.LM_SHAPES
    for shape, s in base.LM_SHAPES.items():
        for cfg, jcfg in ((CONFIG, JAX_CONFIG), (SMOKE, JAX_SMOKE)):
            args = (s["kind"], s["batch"], s["seq"])
            assert base.lm_model_flops(cfg, *args) == \
                jax_base.lm_model_flops(jcfg, *args)
            assert base.lm_attention_correction(cfg, *args) == \
                jax_base.lm_attention_correction(jcfg, *args)
    win = dataclasses.replace(CONFIG, window=4096)
    jwin = dataclasses.replace(JAX_CONFIG, window=4096)
    for kind in ("prefill", "decode", "train"):
        assert base.lm_model_flops(win, kind, 2, 32768) == \
            jax_base.lm_model_flops(jwin, kind, 2, 32768)
        assert base.lm_attention_correction(win, kind, 2, 32768) == \
            jax_base.lm_attention_correction(jwin, kind, 2, 32768)


def test_config_widths_are_the_reference():
    for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "d_head", "d_ff", "vocab", "attn_type", "window", "rope_theta",
              "q_chunk", "kv_chunk"):
        assert getattr(CONFIG, f) == getattr(JAX_CONFIG, f), f
        assert getattr(SMOKE, f) == getattr(JAX_SMOKE, f), f
    assert CONFIG.dtype == torch.bfloat16 and SMOKE.dtype == torch.float32
    assert SMOKE.q_chunk == SMOKE.kv_chunk == 16


def test_unported_variants_raise():
    """MoE and MLA configs construct (they were refused until their
    slice); what is still refused is an unknown attention type, a ``moe``
    that is no ``MoEConfig`` and query heads the KV heads do not
    divide."""
    from repro_torch.models.lm.moe import MoEConfig

    mla = _port_cfg(attn_type="mla")
    assert mla.attn_type == "mla" and mla.kv_lora == 512
    moe = _port_cfg(moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32))
    assert moe.moe.groups == 32 and moe.n_dense == 0
    with pytest.raises(ValueError, match="attn_type"):
        _port_cfg(attn_type="mha")
    with pytest.raises(TypeError, match="MoEConfig"):
        _port_cfg(moe=object())
    with pytest.raises(ValueError, match="multiple"):
        _port_cfg(n_kv_heads=3)


# ------------------------------------------------------------------ layers

def test_rope_freqs_bitwise():
    for d in (8, 64, 128):
        np.testing.assert_array_equal(
            layers.rope_freqs(d, 1e4).numpy(),
            np.asarray(jax_layers.rope_freqs(d, 1e4)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_rope_swiglu_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    xh = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12) + 3, (2, 12)).astype(np.int32)
    ws = [rng.standard_normal(s).astype(np.float32) / 6
          for s in ((32, 48), (32, 48), (48, 32))]
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2

    def j(*a):
        return [jnp.asarray(v).astype(jd) for v in a]

    def t(*a):
        return [v.to(td) for v in _t(*a)]

    def f32(a):
        return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
            else a.float().numpy()

    np.testing.assert_allclose(
        f32(layers.rmsnorm(*t(x, scale))),
        f32(jax_layers.rmsnorm(*j(x, scale)).astype(jnp.float32)),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(
        f32(layers.apply_rope(t(xh)[0], torch.from_numpy(pos), 1e4)),
        f32(jax_layers.apply_rope(j(xh)[0], jnp.asarray(pos),
                                  1e4).astype(jnp.float32)),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(
        f32(layers.swiglu(*t(x, *ws))),
        f32(jax_layers.swiglu(*j(x, *ws)).astype(jnp.float32)),
        rtol=tol, atol=tol)


def test_rope_is_half_split():
    """Feature i pairs with feature i + D/2 (not 2i with 2i + 1)."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0
    out = layers.apply_rope(x, torch.tensor([[1]]))
    assert out[..., 4].item() == pytest.approx(np.sin(1.0), abs=1e-6)
    assert out[..., 1].item() == 0.0


# ------------------------------------------------------------------ attention

@pytest.mark.parametrize("s,window,qc", [(32, None, 8), (64, 16, 16),
                                         (64, None, 32), (128, 16, 32)])
def test_chunked_attention_matches_jax(s, window, qc):
    rng = np.random.default_rng(1)
    B, Hq, Hkv, D = 2, 4, 2, 16
    q = rng.standard_normal((B, s, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, s, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, s, Hkv, D)).astype(np.float32)
    want = np.asarray(jax_attn.chunked_attention(
        *map(jnp.asarray, (q, k, v)), causal=True, window=window,
        q_chunk=qc, kv_chunk=qc))
    got = attention.chunked_attention(*_t(q, k, v), causal=True,
                                      window=window, q_chunk=qc, kv_chunk=qc)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
    # the kernel route (its plain version on the CPU) computes the same
    routed = attention.attention(*_t(q, k, v), window=window,
                                 kernels="kernel")
    np.testing.assert_allclose(routed.numpy(), want, rtol=3e-5, atol=3e-5)


def test_chunked_attention_refuses_ragged_chunks_and_unknown_modes():
    q = torch.zeros(1, 24, 2, 8)
    with pytest.raises(ValueError, match="multiples"):
        attention.chunked_attention(q, q, q, q_chunk=16, kv_chunk=16)
    with pytest.raises(ValueError, match="kernels"):
        attention.attention(q, q, q, kernels="fast")


@pytest.mark.parametrize("window,cache_len", [(None, 1), (None, 13),
                                              (8, 20), (None, 24)])
def test_decode_attention_matches_jax(window, cache_len):
    rng = np.random.default_rng(2)
    B, S, Hq, Hkv, D = 2, 24, 8, 2, 16
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    want = np.asarray(jax_attn.decode_attention(
        *map(jnp.asarray, (q, kc, vc)), jnp.int32(cache_len), window=window))
    got = attention.decode_attention(*_t(q, kc, vc), cache_len,
                                     window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------------ the model

@pytest.mark.parametrize("kernels", ["kernel", "reference"])
def test_lm_forward_smoke_f32_matches_jax(kernels):
    jcfg, tcfg, params, model = _models()
    toks = _tokens(0, 2, 32)
    want, _ = jax_tf.lm_forward(params, jnp.asarray(toks), jcfg)
    reset_launches()
    got, aux = transformer.lm_forward(model, torch.from_numpy(toks), kernels)
    assert not any(launch_counts().values())
    assert aux == 0.0 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_lm_forward_smoke_bf16_matches_jax():
    """bf16 weights and residual stream: the two frameworks round at other
    places (matmul outputs, silu, RoPE), so the logits agree to 3e-2 of
    their largest magnitude (measured: ~1.0e-2)."""
    jcfg, tcfg, params, model = _models(
        jkw=dict(dtype=jnp.bfloat16), tkw=dict(dtype=torch.bfloat16))
    toks = _tokens(1, 2, 32)
    want = np.asarray(jax_tf.lm_forward(params, jnp.asarray(toks), jcfg)[0])
    got, _ = transformer.lm_forward(model, torch.from_numpy(toks))
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < 3e-2, err


def test_kernel_mode_equals_reference_mode_on_cpu():
    _, tcfg, _, model = _models(seed=3)
    toks = torch.from_numpy(_tokens(2, 2, 48))
    a, _ = transformer.lm_forward(model, toks, "kernel")
    b, _ = transformer.lm_forward(model, toks, "reference")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5, atol=2e-5)


def test_prefill_step_is_the_references_last_logits():
    jcfg, tcfg, params, model = _models(seed=4)
    toks = _tokens(3, 3, 32)
    full, _ = jax_tf.lm_forward(params, jnp.asarray(toks), jcfg)
    for kernels in ("kernel", "reference"):
        got = make_prefill_step(tcfg, kernels, "cpu")(
            model, torch.from_numpy(toks))
        assert got.shape == (3, tcfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(full)[:, -1],
                                   rtol=1e-5, atol=1e-5)
        # the port's own full logits in the same mode, last position
        mine, _ = transformer.lm_forward(model, torch.from_numpy(toks),
                                         kernels)
        np.testing.assert_allclose(got.numpy(), mine[:, -1].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_decode_steps_match_jax_with_equal_caches():
    jcfg, tcfg, params, model = _models(seed=5)
    B, T = 2, 12
    toks = _tokens(4, B, T)
    jcache = jax_tf.init_kv_cache(jcfg, B, T + 4)
    cache = transformer.init_kv_cache(tcfg, B, T + 4, device="cpu")
    step = make_decode_step(tcfg, "kernel", "cpu")
    for t in range(T):
        want, jcache = jax_tf.lm_decode_step(
            params, jcache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t + 1),
            jcfg)
        got, cache = step(model, cache, torch.from_numpy(toks[:, t:t + 1]),
                          t + 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        for name in ("k", "v"):
            np.testing.assert_allclose(
                cache[name].numpy(), np.asarray(jcache["scan"][name]),
                rtol=1e-5, atol=1e-5)
    assert not cache["k"][:, :, T:].any()         # untouched past the tokens


@pytest.mark.parametrize("window", [None, 8])
def test_decode_equals_forward_roundtrip(window):
    """The reference's decode == forward check (tests/test_lm.py), on the
    port: each position's decode logits against the full forward's."""
    jkw = dict(window=window, n_layers=2)
    _, tcfg, _, model = _models(seed=6, jkw=jkw, tkw=jkw)
    T = 16
    toks = torch.from_numpy(_tokens(5, 1, T))
    full, _ = transformer.lm_forward(model, toks)
    cache = transformer.init_kv_cache(tcfg, 1, T, device="cpu")
    outs = []
    for t in range(T):
        lg, cache = transformer.lm_decode_step(model, cache,
                                               toks[:, t:t + 1], t + 1)
        outs.append(lg)
    dec = torch.stack(outs, dim=1)
    err = float((dec - full).abs().max() / full.abs().max())
    assert err < 2e-5, err


def test_decode_step_refuses_a_position_outside_the_cache():
    _, tcfg, _, model = _models(seed=7)
    cache = transformer.init_kv_cache(tcfg, 1, 4, device="cpu")
    tok = torch.zeros(1, 1, dtype=torch.int32)
    for bad in (0, 5):
        with pytest.raises(ValueError, match="cache_len"):
            transformer.lm_decode_step(model, cache, tok, bad)


def test_steps_refuse_another_config_or_device():
    _, tcfg, _, model = _models(seed=8)
    step = make_prefill_step(_port_cfg(n_layers=1), "kernel", "cpu")
    with pytest.raises(ValueError, match="step"):
        step(model, torch.zeros(1, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="kernels"):
        make_decode_step(tcfg, "fast", "cpu")


def test_init_lm_params_layouts_and_scales():
    cfg = _port_cfg(d_model=256, d_ff=512, vocab=1024)
    m = transformer.init_lm_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
    jshapes = jax.eval_shape(
        lambda k: jax_tf.init_lm_params(k, _jax_cfg(
            d_model=256, d_ff=512, vocab=1024)), jax.random.PRNGKey(0))
    got = lm_to_numpy(m)
    assert jax.tree.map(np.shape, got) == jax.tree.map(
        lambda s: tuple(s.shape), jshapes)
    blk = m.layers[0]
    assert float(m.embed.std()) == pytest.approx(0.02, rel=0.05)
    assert float(blk.wq.std()) == pytest.approx(256 ** -0.5, rel=0.05)
    assert float(blk.wo.std()) == pytest.approx(64 ** -0.5, rel=0.05)
    assert float(blk.w_down.std()) == pytest.approx(512 ** -0.5, rel=0.05)
    assert torch.equal(m.final_norm, torch.ones(256))
    assert not any(p.requires_grad for p in m.parameters())
    assert sum(p.numel() for p in m.parameters()) == \
        cfg.param_count() + cfg.d_model          # + the final norm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converters_round_trip_bitwise(dtype):
    jcfg, tcfg, params, model = _models(
        seed=9, jkw=dict(dtype=getattr(jnp, dtype)),
        tkw=dict(dtype=getattr(torch, dtype)))
    back = lm_to_numpy(model)
    la, lb = jax.tree.leaves(back), jax.tree.leaves(params)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    assert all(a.dtype == b.dtype and a.shape == b.shape
               and a.tobytes() == b.tobytes() for a, b in zip(la, lb))
    again = lm_from_jax(back, tcfg, "cpu")
    assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(again.parameters(), model.parameters()))
    with pytest.raises(ValueError, match="config wants"):
        lm_from_jax(params, _port_cfg(dtype=torch.float64), "cpu")


def test_entry_points_raise_without_a_card(monkeypatch):
    from repro_torch.launch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.LM(SMOKE)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_prefill_step(SMOKE)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_decode_step(SMOKE)
    with pytest.raises(RuntimeError, match="CUDA"):
        transformer.init_kv_cache(SMOKE, 1, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "phi3-medium-14b", "--shape", "prefill_32k",
              "--smoke"])
    assert transformer.LM(SMOKE, device="cpu").device == torch.device("cpu")


# ------------------------------------------------------------------ launcher

@pytest.mark.parametrize("argv,code,say", [
    (["--smoke", "--device", "cpu"], 0, "phi3-medium-14b smoke: {'loss'"),
    (["--shape", "train_4k", "--smoke", "--device", "cpu"], 0,
     "3 steps: loss"),
    (["--shape", "train_4k", "--smoke", "--device", "cpu", "--layers", "1",
      "--seq", "32", "--steps", "2"], 0, "2 steps: loss"),
    (["--shape", "train_4k", "--seq", "64"], 2,
     "--seq cuts train_4k only with --smoke"),
    ([], 2, "no --shape"),
    (["--shape", "nope"], 2, "unknown shape"),
    (["--shape", "prefill_32k", "--offload"], 2, "requires a GNN arch"),
    (["--shape", "long_500k"], 0,
     "full-attention arch: long_500k requires sub-quadratic attention"),
    (["--shape", "prefill_32k", "--smoke", "--device", "cpu", "--seq", "48"],
     0, "wall"),
    (["--shape", "prefill_32k", "--smoke", "--device", "cpu", "--kernels",
      "reference", "--layers", "1"], 0, "1 layers"),
    (["--shape", "decode_32k", "--smoke", "--device", "cpu", "--seq", "6"],
     0, "6 steps"),
    (["--shape", "decode_32k", "--smoke", "--device", "cpu", "--seq", "4",
      "--profile"], 0, "profile: wall"),
])
def test_launcher_lm_exit_codes_on_cpu(argv, code, say, capsys):
    from repro_torch.launch.train import main

    with pytest.raises(SystemExit) as ei:
        main(["--arch", "phi3-medium-14b", *argv])
    assert ei.value.code == code
    assert say in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["command-r-plus-104b", "deepseek-67b"])
def test_launcher_runs_the_other_dense_ids_on_cpu(arch, capsys):
    from repro_torch.launch.train import main

    for argv, say in ((["--smoke"], f"{arch} smoke: {{'loss'"),
                      (["--shape", "train_4k", "--smoke", "--steps", "2"],
                       "2 steps: loss"),
                      (["--shape", "prefill_32k", "--smoke", "--seq", "32"],
                       "flash_attention launches 0 (want 0)")):
        with pytest.raises(SystemExit) as ei:
            main(["--arch", arch, "--device", "cpu", *argv])
        assert ei.value.code == 0
        assert say in capsys.readouterr().out


def test_cell_bytes_and_the_refusal_of_a_cell_that_cannot_fit(
        monkeypatch, capsys):
    """``lm_cell_bytes`` by term at Phi-3's widths; a cell whose reckoning
    exceeds the device's memory is refused before anything is allocated
    (the device's bytes replaced by an 80 GB card's)."""
    from repro_torch.launch import train

    cut = dataclasses.replace(CONFIG, n_layers=4)
    b = train.lm_cell_bytes(cut, "train", 2, 4096)
    n = cut.param_count() + cut.d_model
    assert n == 2_390_799_360
    assert (b["params"], b["grads"], b["adamw"]) == (2 * n, 2 * n, 8 * n)
    assert b["logits"] == 16 * 2 * 4096 * 100352
    assert b["total"] == sum(v for k, v in b.items() if k != "total")
    assert 46e9 < b["total"] < 47e9
    d = train.lm_cell_bytes(CONFIG, "decode", 4, 32768)
    assert d["cache"] == 2 * 40 * 4 * 32768 * 10 * 128 * 2
    assert d["params"] == 2 * (CONFIG.param_count() + CONFIG.d_model)
    assert train.lm_cell_bytes(CONFIG, "prefill", 1, 32768)["total"] < 80e9
    monkeypatch.setattr(train, "_device_bytes", lambda dev: 80 * 10 ** 9)
    for arch, shape, batch in (("phi3-medium-14b", "train_4k", 256),
                               ("phi3-medium-14b", "decode_32k", 128),
                               ("command-r-plus-104b", "prefill_32k", 32)):
        from repro_torch.configs import REGISTRY

        s = base.LM_SHAPES[shape]
        full = train.lm_cell_bytes(REGISTRY[arch].config, s["kind"], batch,
                                   s["seq"])["total"]
        with pytest.raises(SystemExit) as ei:
            train.main(["--arch", arch, "--shape", shape, "--device", "cpu"])
        assert ei.value.code == 1
        out = capsys.readouterr().out
        assert f"need {full / 1e9:.2f} GB" in out and "80.00 GB" in out


@pytest.mark.parametrize("cut, code, say", [
    ([], 1, "cut it with --layers / --batch"),
    (["--layers", "1"], 0, "so it runs as asked"),
    (["--batch", "1"], 0, "so it runs as asked"),
])
def test_only_an_uncut_cell_is_refused_on_its_reckoning(
        cut, code, say, monkeypatch, capsys):
    """On a device the reckoning exceeds (1 byte here), the cell run with
    no cut of depth or batch is refused; a cell cut in depth or batch runs,
    with the reckoning printed."""
    from repro_torch.launch import train

    monkeypatch.setattr(train, "_device_bytes", lambda dev: 1)
    with pytest.raises(SystemExit) as ei:
        train.main(["--arch", "phi3-medium-14b", "--shape", "train_4k",
                    "--smoke", "--device", "cpu", "--seq", "16",
                    "--steps", "1", *cut])
    assert ei.value.code == code
    assert say in capsys.readouterr().out


# ------------------------------------------------------------------ MoE, MLA

MOE_IDS = ["mixtral-8x7b", "deepseek-v2-236b"]


def _moe_cfgs(name, **kw):
    """The reference's and the port's ``SMOKE`` of an MoE id."""
    import importlib

    mod = name.replace("-", "_")
    j = importlib.import_module(f"repro.configs.{mod}").SMOKE
    t = importlib.import_module(f"repro_torch.configs.{mod}").SMOKE
    jkw = {k: (getattr(jnp, str(v).split(".")[-1]) if k == "dtype" else v)
           for k, v in kw.items()}
    return dataclasses.replace(j, **jkw), dataclasses.replace(t, **kw)


def _moe_models(name, seed=0, **kw):
    jcfg, tcfg = _moe_cfgs(name, **kw)
    params = _np(jax.jit(lambda k: jax_tf.init_lm_params(k, jcfg))(
        jax.random.PRNGKey(seed)))
    return jcfg, tcfg, params, lm_from_jax(params, tcfg, "cpu")


def test_moe_mla_config_counts_equal_the_reference():
    """``param_count`` / ``active_param_count`` and the FLOP counts are the
    reference's formulas (its quirk included: DeepSeek-V2's dense first
    layer counted as an MoE layer, MLA's norms left out), and
    ``count_params`` counts the real leaves, the reference's
    ``init_lm_params`` leaves plus nothing."""
    import importlib

    for name in MOE_IDS:
        mod = name.replace("-", "_")
        j = importlib.import_module(f"repro.configs.{mod}")
        t = importlib.import_module(f"repro_torch.configs.{mod}")
        for tc, jc in ((t.CONFIG, j.CONFIG), (t.SMOKE, j.SMOKE)):
            assert tc.param_count() == jc.param_count()
            assert tc.active_param_count() == jc.active_param_count()
            for shape, s in base.LM_SHAPES.items():
                args = (s["kind"], s["batch"], s["seq"])
                assert base.lm_model_flops(tc, *args) == \
                    jax_base.lm_model_flops(jc, *args)
                assert base.lm_attention_correction(tc, *args) == \
                    jax_base.lm_attention_correction(jc, *args)
        shapes = jax.eval_shape(lambda k: jax_tf.init_lm_params(k, j.SMOKE),
                                jax.random.PRNGKey(0))
        leaves = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
        assert transformer.count_params(t.SMOKE) == leaves
    from repro_torch.configs import deepseek_v2_236b as ds
    from repro_torch.configs import mixtral_8x7b as mx

    ds3 = dataclasses.replace(ds.CONFIG, n_layers=3)
    assert transformer.count_params(ds3) == 9_330_795_520
    assert ds3.param_count() == 12_964_919_296
    # the dense first layer counted at the MoE width (+3,634,135,040), the
    # final norm (-5,120) and each layer's q_norm and kv_norm (-2,048)
    # left out
    for L in (3, 60):
        c = dataclasses.replace(ds.CONFIG, n_layers=L)
        assert c.param_count() - transformer.count_params(c) == \
            3_634_129_920 - 2048 * L
    mx8 = dataclasses.replace(mx.CONFIG, n_layers=8)
    assert transformer.count_params(mx8) == mx8.param_count() + 4096


@pytest.mark.parametrize("kernels", ["kernel", "reference"])
@pytest.mark.parametrize("name", MOE_IDS)
def test_moe_lm_forward_matches_jax(name, kernels):
    jcfg, tcfg, params, model = _moe_models(name)
    toks = _tokens(0, 2, 32)
    want, waux = jax.jit(lambda p, t: jax_tf.lm_forward(p, t, jcfg))(
        params, jnp.asarray(toks))
    reset_launches()
    got, aux = transformer.lm_forward(model, torch.from_numpy(toks), kernels)
    assert not any(launch_counts().values())
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(aux) - float(waux)) <= 1e-5
    last = make_prefill_step(tcfg, kernels, "cpu")(model,
                                                   torch.from_numpy(toks))
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", MOE_IDS)
def test_moe_decode_steps_match_jax_with_equal_caches(name):
    """Every step's logits and every layer's cache (the port's entries,
    in ``LM.blocks()`` order, against the reference's ``dense`` then
    ``scan`` layers) within 1e-5."""
    jcfg, tcfg, params, model = _moe_models(name, seed=5)
    B, T = 3, 12
    toks = _tokens(4, B, T)
    jcache = jax_tf.init_kv_cache(jcfg, B, T + 4)
    cache = transformer.init_kv_cache(tcfg, B, T + 4, device="cpu")
    assert list(cache) == list(jcache["scan"])
    jstep = jax.jit(lambda p, c, t, n: jax_tf.lm_decode_step(p, c, t, n,
                                                             jcfg))
    step = make_decode_step(tcfg, "kernel", "cpu")
    for t in range(T):
        want, jcache = jstep(params, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t + 1))
        got, cache = step(model, cache, torch.from_numpy(toks[:, t:t + 1]),
                          t + 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    for k, c in cache.items():
        want = np.concatenate([np.asarray(jcache[g][k]) for g in
                               ("dense", "scan") if jcache[g] is not None])
        np.testing.assert_allclose(c.numpy(), want, rtol=1e-5, atol=1e-5)
        assert not c[:, :, T:].any()           # untouched past the tokens


@pytest.mark.parametrize("name", MOE_IDS)
def test_moe_decode_equals_forward_roundtrip(name):
    """Decode token by token against the full forward: at ``SMOKE`` every
    group holds one token (32 groups), no assignment is dropped either
    way, so the routing is the same and the logits agree to float32's
    rounding."""
    from repro_torch.models.lm.moe import moe_shape

    _, tcfg, _, model = _moe_models(name, seed=6)
    T = 16
    G, C = moe_shape(tcfg.moe, T)
    assert G == T and tcfg.moe.top_k <= C
    toks = torch.from_numpy(_tokens(5, 1, T))
    full, _ = transformer.lm_forward(model, toks)
    cache = transformer.init_kv_cache(tcfg, 1, T, device="cpu")
    dec = torch.stack([transformer.lm_decode_step(
        model, cache, toks[:, t:t + 1], t + 1)[0] for t in range(T)], dim=1)
    err = float((dec - full).abs().max() / full.abs().max())
    assert err < 2e-5, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE_IDS)
def test_moe_converters_round_trip_bitwise(name, dtype):
    """Both ways bitwise, every leaf in its own dtype: the router float32
    in a bf16 model, as the reference keeps it."""
    jcfg, tcfg, params, model = _moe_models(
        name, seed=9, dtype=getattr(torch, dtype))
    assert model.layers[0].router.dtype == torch.float32
    assert model.layers[0].w_gate.dtype == getattr(torch, dtype)
    back = lm_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    assert all(a.dtype == b.dtype and a.shape == b.shape
               and a.tobytes() == b.tobytes()
               for a, b in zip(jax.tree.leaves(back),
                               jax.tree.leaves(params)))
    again = lm_from_jax(back, tcfg, "cpu")
    assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for a, b in zip(again.parameters(), model.parameters()))


@pytest.mark.parametrize("name", MOE_IDS)
def test_moe_init_layouts_and_scales(name):
    """``init_lm_params``' leaves have the reference's tree, shapes and
    dtypes; the router is drawn at 0.02, an expert weight at ``1 /
    sqrt(E)`` (the reference's fan-in of an ``(E, d, ff)`` leaf), MLA's
    ``w_o`` at ``1 / sqrt(H * v_head_dim)``, the norms are ones."""
    jcfg, tcfg = _moe_cfgs(name, dtype=torch.bfloat16, d_model=256,
                           vocab=512)
    m = transformer.init_lm_params(tcfg, torch.Generator().manual_seed(0),
                                   "cpu")
    ref = jax.eval_shape(lambda k: jax_tf.init_lm_params(k, jcfg),
                         jax.random.PRNGKey(0))
    got = lm_to_numpy(m)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    assert jax.tree.map(lambda a: (a.shape, np.dtype(a.dtype)), got) == \
        jax.tree.map(lambda a: (tuple(a.shape), np.dtype(a.dtype)), ref)
    blk = m.layers[0]
    E = tcfg.moe.n_experts
    assert float(blk.router.std()) == pytest.approx(0.02, rel=0.1)
    assert float(blk.w_up.float().std()) == pytest.approx(E ** -0.5,
                                                          rel=0.1)
    if tcfg.attn_type == "mla":
        H, dv = tcfg.n_heads, tcfg.v_head_dim
        assert float(blk.w_o.float().std()) == pytest.approx(
            (H * dv) ** -0.5, rel=0.1)
        assert torch.equal(blk.q_norm, torch.ones_like(blk.q_norm))
        assert len(m.dense_layers) == 1
        assert m.dense_layers[0].w_gate.shape == (256, tcfg.moe.d_ff_dense)
    assert not any(p.requires_grad for p in m.parameters())
    assert sum(p.numel() for p in m.parameters()) == \
        transformer.count_params(tcfg)


@pytest.mark.parametrize("name", MOE_IDS)
def test_launcher_runs_the_moe_ids_on_cpu(name, capsys):
    """``--smoke`` and the cut cells of both MoE ids exit 0 on the CPU;
    Mixtral's ``long_500k`` (a sliding window) runs, DeepSeek-V2's is
    skipped with the reference's reason."""
    from repro_torch.launch.train import main

    runs = [(["--smoke"], f"{name} smoke: {{'loss'"),
            (["--shape", "train_4k", "--smoke", "--steps", "2"],
             "2 steps: loss"),
            (["--shape", "prefill_32k", "--smoke", "--seq", "32"],
             "flash_attention launches 0 (want 0)"),
            (["--shape", "decode_32k", "--smoke", "--seq", "6"], "6 steps"),
            (["--shape", "prefill_32k", "--smoke", "--layers", "1",
              "--seq", "32"], "1 layers")]
    if name == "mixtral-8x7b":
        runs.append((["--shape", "long_500k", "--smoke", "--seq", "40",
                      "--batch", "1"], "32 steps"))
    else:
        runs.append((["--shape", "long_500k"], "skipped: full-attention"))
    for argv, say in runs:
        with pytest.raises(SystemExit) as ei:
            main(["--arch", name, "--device", "cpu", *argv])
        out = capsys.readouterr().out
        assert ei.value.code == 0, out
        assert say in out, out
    with pytest.raises(SystemExit) as ei:
        main(["--arch", name, "--device", "cpu"])
    assert ei.value.code == 2
    assert ("long_500k" in capsys.readouterr().out) == (
        name == "mixtral-8x7b")


def test_cell_bytes_moe_and_mla_terms():
    """``lm_cell_bytes``' MoE prefill working set (the ``G * E * C``
    dispatch rows at ``d`` and ``3 d_ff_expert``, the token copies), the
    MLA attention and latent cache, and the dense layers' width."""
    from repro_torch.configs import deepseek_v2_236b as ds
    from repro_torch.configs import mixtral_8x7b as mx
    from repro_torch.launch import train

    mx8 = dataclasses.replace(mx.CONFIG, n_layers=8)
    p = train.lm_cell_bytes(mx8, "prefill", 1, 32768)
    assert p["moe"] == (32 * 8 * 320 * (4096 + 3 * 14336)
                        + 2 * 32768 * 2 * 4096) * 2
    assert p["layer"] == 32768 * 4 * 4096 * 2          # no dense FFN
    d = train.lm_cell_bytes(ds.CONFIG, "decode", 4, 32768)
    assert d["cache"] == 60 * 4 * 32768 * (512 + 64) * 2
    assert d["cache_f32"] == 4 * 4 * 32768 * (512 + 64)
    q = train.lm_cell_bytes(ds.CONFIG, "prefill", 1, 32768)
    assert q["layer"] == 32768 * (5120 + 128 * (2 * 192 + 2 * 128)
                                  + 3 * 12288) * 2
    assert q["moe"] == (32 * 160 * 48 * (5120 + 3 * 1536)
                        + 2 * 32768 * 6 * 5120) * 2
    assert q["total"] == sum(v for k, v in q.items() if k != "total")
    lg = train.lm_cell_bytes(dataclasses.replace(mx.CONFIG, n_layers=2),
                             "decode", 1, 524288)
    assert lg["cache"] == 2 * 524288 * 2 * 8 * 128 * 2    # 4.3 GB


def test_a_cut_to_the_dense_first_layer_runs():
    """DeepSeek-V2 cut to its dense first layer alone: no MoE layer and an
    aux of 0.0, one cache layer, decode == forward in float32;
    its weights are a deeper cut's embedding, head and first layer (the
    same draws in the same order)."""
    _, one = _moe_cfgs("deepseek-v2-236b", n_layers=1)
    _, two = _moe_cfgs("deepseek-v2-236b", n_layers=2)
    m1, m2 = (transformer.init_lm_params(c, torch.Generator().manual_seed(0),
                                         "cpu") for c in (one, two))
    assert len(m1.layers) == 0 and len(m1.dense_layers) == 1
    n2 = dict(m2.named_parameters())
    assert all(torch.equal(p, n2[k]) for k, p in m1.named_parameters())
    toks = torch.from_numpy(_tokens(7, 1, 16))
    full, aux = transformer.lm_forward(m1, toks)
    assert aux == 0.0
    cache = transformer.init_kv_cache(one, 1, 16, device="cpu")
    assert cache["ckv"].shape[0] == 1 and cache["kr"].shape[0] == 1
    dec = torch.stack([transformer.lm_decode_step(
        m1, cache, toks[:, t:t + 1], t + 1)[0] for t in range(16)], dim=1)
    assert float((dec - full).abs().max() / full.abs().max()) < 2e-5
