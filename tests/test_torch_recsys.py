"""The port's two-tower retrieval model, its converters, its training and
serving drivers and the launcher's recsys smoke against the JAX model.

Both packages get the same weights (the reference's ``init_two_tower``
through ``two_tower_from_jax``) and the same numpy ids. Tolerances (the
ROADMAP's): tower embeddings within 1e-5, the loss within 1e-4, gradients
and AdamW-updated parameters within 5e-4, each relative to the largest
magnitude of the reference's leaf; candidate scores within 1e-6 and top-k
indices exactly. Float32 matrix products in another order (XLA:CPU vs ATen)
are the only difference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.recsys import two_tower as jt
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update

from repro_torch.configs.base import RECSYS_SHAPES, recsys_model_flops
from repro_torch.configs.two_tower_retrieval import CONFIG, SMOKE
from repro_torch.examples import serve_retrieval, train_two_tower
from repro_torch.models.lm.layers import init_dense
from repro_torch.models.recsys import two_tower as tt
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.params import (
    two_tower_from_jax, two_tower_grads_to_jax, two_tower_to_numpy,
)
from repro_torch.train import LoopConfig, run_training_loop

JCFG = jt.TwoTowerConfig(
    embed_dim=16, tower_mlp=(32, 16), n_user_fields=3, n_item_fields=2,
    bag_size=4, user_vocab=500, item_vocab=500,
)
CFG = tt.TwoTowerConfig(
    embed_dim=16, tower_mlp=(32, 16), n_user_fields=3, n_item_fields=2,
    bag_size=4, user_vocab=500, item_vocab=500,
)


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _tree_close(got, want, tol):
    gl, gdef = jax.tree.flatten(got)
    wl, wdef = jax.tree.flatten(want)
    assert gdef == wdef
    for g, w in zip(gl, wl):
        assert np.shape(g) == np.shape(w)
        _close(g, w, tol)


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jt.init_two_tower(jax.random.PRNGKey(0),
                                                      JCFG))


def _ids(seed, b, n_fields, vocab=500, bag=4):
    return np.random.default_rng(seed).integers(
        0, vocab, (b, n_fields, bag)).astype(np.int32)


def _correlated(b=64):
    base = np.random.default_rng(0).integers(0, 500, (b,))
    u = np.stack([base] * 3, 1)[:, :, None].repeat(4, 2).astype(np.int32)
    i = np.stack([base] * 2, 1)[:, :, None].repeat(4, 2).astype(np.int32)
    return u, i


def test_converters_round_trip(jparams):
    model = two_tower_from_jax(jparams, device="cpu")
    assert [n for n, _ in model.named_parameters()] == [
        "user_table", "item_table", "user_mlp.0.w", "user_mlp.0.b",
        "user_mlp.1.w", "user_mlp.1.b", "item_mlp.0.w", "item_mlp.0.b",
        "item_mlp.1.w", "item_mlp.1.b"]
    back = two_tower_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)


def test_towers_and_loss_match_jax(jparams):
    model = two_tower_from_jax(jparams, device="cpu")
    u, i = _ids(1, 16, 3), _ids(2, 16, 2)
    tu, ti = torch.from_numpy(u), torch.from_numpy(i)
    _close(tt.user_embedding(model, tu, CFG).detach(),
           jt.user_embedding(jparams, jnp.asarray(u), JCFG), 1e-5)
    _close(tt.item_embedding(model, ti, CFG).detach(),
           jt.item_embedding(jparams, jnp.asarray(i), JCFG), 1e-5)
    served = tt.serve_user_tower(model, tu, CFG)
    assert not served.requires_grad
    _close(served, jt.serve_user_tower(jparams, jnp.asarray(u), JCFG), 1e-5)
    np.testing.assert_allclose(torch.linalg.vector_norm(served, dim=-1), 1.0,
                               atol=1e-5)

    (loss, acc), grads = tt.two_tower_value_and_grad(model, tu, ti, CFG)
    (jloss, jacc), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jt.two_tower_loss(p, jnp.asarray(u), jnp.asarray(i), JCFG),
        has_aux=True))(jax.tree.map(jnp.asarray, jparams))
    _close(float(loss), float(jloss), 1e-4)
    assert float(acc) == float(jacc)
    _tree_close(two_tower_grads_to_jax(grads),
                jax.tree.map(np.asarray, jgrads), 5e-4)
    # the loss function itself (not through the value-and-grad helper)
    l2, a2 = tt.two_tower_loss(model, tu, ti, CFG, kernels="reference")
    assert float(l2.detach()) == float(loss) and float(a2) == float(acc)


def test_score_candidates_matches_jax(jparams):
    model = two_tower_from_jax(jparams, device="cpu")
    u = _ids(3, 2, 3)
    cand_ids = _ids(4, 300, 2)
    cand = np.array(jt.item_embedding(jparams, jnp.asarray(cand_ids), JCFG))
    jv, ji = jt.score_candidates(jparams, jnp.asarray(u), cand, JCFG,
                                 top_k=10)
    tv, ti = tt.score_candidates(model, torch.from_numpy(u),
                                 torch.from_numpy(cand), CFG,
                                 top_k=10)
    assert tv.shape == (2, 10) and ti.shape == (2, 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tv.numpy(), np.asarray(jv), 1e-6)
    assert np.all(np.diff(tv.numpy(), axis=1) <= 0)
    full = tt.serve_user_tower(model, torch.from_numpy(u), CFG) @ \
        torch.from_numpy(cand).T
    np.testing.assert_array_equal(ti[:, 0].numpy(), full.argmax(-1).numpy())


def test_three_adamw_steps_match_jax(jparams):
    model = two_tower_from_jax(jparams, device="cpu")
    opt = adamw_init(model)
    jp = jax.tree.map(jnp.asarray, jparams)
    jo = jax_adamw_init(jp)
    u, i = _correlated(32)
    tu, ti = torch.from_numpy(u), torch.from_numpy(i)

    @jax.jit
    def jstep(p, o):
        _, g = jax.value_and_grad(
            lambda pp: jt.two_tower_loss(pp, jnp.asarray(u), jnp.asarray(i),
                                         JCFG), has_aux=True)(p)
        return jax_adamw_update(g, p, o, lr=3e-3)

    for _ in range(3):
        _, grads = tt.two_tower_value_and_grad(model, tu, ti, CFG)
        model, opt = adamw_update(grads, model, opt, lr=3e-3)
        jp, jo = jstep(jp, jo)
    assert isinstance(model, tt.TwoTower) and int(opt["step"]) == 3
    _tree_close(two_tower_to_numpy(model), jax.tree.map(np.asarray, jp), 5e-4)


def test_train_improves_retrieval_accuracy():
    """The reference's 30-step property (``tests/test_recsys.py``), on the
    port alone: correlated user and item ids, AdamW at 3e-3."""
    model = tt.init_two_tower(CFG, torch.Generator().manual_seed(0),
                              device="cpu")
    opt = adamw_init(model)
    u, i = (torch.from_numpy(a) for a in _correlated(64))
    accs = []
    for _ in range(30):
        (_, acc), grads = tt.two_tower_value_and_grad(model, u, i, CFG)
        model, opt = adamw_update(grads, model, opt, lr=3e-3)
        accs.append(float(acc))
    assert accs[-1] > accs[0] + 0.3


def test_init_two_tower_shapes_scales_and_seed():
    g = lambda: torch.Generator().manual_seed(0)
    m1 = tt.init_two_tower(SMOKE, g(), device="cpu")
    m2 = tt.init_two_tower(SMOKE, g(), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m1.parameters(),
                                                 m2.parameters()))
    assert m1.user_table.shape == (1000, 16) and m1.item_table.shape == (1000, 16)
    assert [tuple(l.w.shape) for l in m1.user_mlp] == [(128, 32), (32, 16)]
    assert [tuple(l.w.shape) for l in m1.item_mlp] == [(64, 32), (32, 16)]
    assert abs(float(m1.user_table.detach().std()) - 0.01) < 1e-3
    assert not any(l.b.any() for l in m1.user_mlp)
    w = init_dense(torch.Generator().manual_seed(1), (400, 300))
    assert w.dtype == torch.float32 and abs(float(w.std()) - 0.05) < 2e-3


def test_kernel_routes_on_cpu_and_bad_route():
    model = tt.init_two_tower(SMOKE, torch.Generator().manual_seed(0),
                              device="cpu")
    u = torch.from_numpy(_ids(1, 4, 8, vocab=1000))
    outs = [tt.user_embedding(model, u, SMOKE, k).detach()
            for k in ("auto", "kernel", "reference")]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    with pytest.raises(ValueError, match="kernels"):
        tt.user_embedding(model, u, SMOKE, "pallas")


def test_configs_match_the_reference():
    from repro.configs import base as jbase
    from repro.configs import two_tower_retrieval as jconf

    assert RECSYS_SHAPES == jbase.RECSYS_SHAPES
    for f in ("embed_dim", "tower_mlp", "n_user_fields", "n_item_fields",
              "bag_size", "user_vocab", "item_vocab", "temperature", "name"):
        assert getattr(CONFIG, f) == getattr(jconf.CONFIG, f)
    assert (SMOKE.embed_dim, SMOKE.tower_mlp, SMOKE.bag_size,
            SMOKE.user_vocab, SMOKE.item_vocab) == (16, (32, 16), 4, 1000, 1000)
    for name, s in RECSYS_SHAPES.items():
        assert recsys_model_flops(CONFIG, s["kind"], s["batch"],
                                  s.get("n_candidates", 0)) == \
            jbase.recsys_model_flops(jconf.CONFIG, s["kind"], s["batch"],
                                     s.get("n_candidates", 0))


def _example_loop(cfg, ckpt, steps, batch_fn, step_fn):
    params = tt.init_two_tower(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    return run_training_loop(
        LoopConfig(total_steps=steps, ckpt_dir=ckpt, ckpt_every=3,
                   log_every=100),
        params, adamw_init(params), step_fn, batch_fn, log_fn=lambda m: None)


def test_training_loop_resume_is_bitwise(tmp_path):
    """The example's batch and step functions through ``run_training_loop``:
    6 steps, then a second loop from the step-6 checkpoint to 9, equal to 9
    straight steps bitwise."""
    cfg = tt.TwoTowerConfig(embed_dim=8, tower_mlp=(16, 8), n_user_fields=2,
                            n_item_fields=2, bag_size=3, user_vocab=300,
                            item_vocab=300)
    batch_fn = train_two_tower.make_batch_fn(cfg, 16, 300, "cpu")
    step_fn = train_two_tower.make_step_fn(cfg)
    ref_p, ref_o, ref_s = _example_loop(cfg, None, 9, batch_fn, step_fn)
    ckpt = str(tmp_path / "ck")
    _example_loop(cfg, ckpt, 6, batch_fn, step_fn)
    p, o, s = _example_loop(cfg, ckpt, 9, batch_fn, step_fn)
    assert s.losses == ref_s.losses[6:] and len(s.losses) == 3
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(),
                                                 ref_p.parameters()))
    assert torch.equal(o["step"], ref_o["step"])
    assert all(torch.equal(o["m"][k], ref_o["m"][k]) for k in o["m"])
    # the batches are a pure function of the step
    assert all(torch.equal(a, b) for a, b in zip(batch_fn(4), batch_fn(4)))


def test_train_example_runs_on_cpu(tmp_path, capsys):
    params, _, state = train_two_tower.main([
        "--steps", "3", "--batch", "8", "--vocab", "200",
        "--ckpt", str(tmp_path / "ck"), "--device", "cpu"])
    assert state.step == 3 and len(state.losses) == 3
    assert all(np.isfinite(state.losses))
    assert params.user_table.shape == (200, 256)
    assert "finished at step 3" in capsys.readouterr().out


def test_serve_example_runs_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr(serve_retrieval, "N_CAND", 3000)
    r = serve_retrieval.main(["--device", "cpu"])
    assert r["corpus"].shape == (3000, 64)
    assert r["values"].shape == (8, 100) and r["indices"].shape == (8, 100)
    assert bool(torch.isfinite(r["values"]).all())
    np.testing.assert_allclose(torch.linalg.vector_norm(r["corpus"], dim=-1),
                               1.0, atol=1e-5)
    assert "retrieval over 3000 candidates" in capsys.readouterr().out


def test_build_corpus_in_chunks_equals_one_call():
    cfg = serve_retrieval.make_config()
    model = tt.init_two_tower(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    a = serve_retrieval.build_corpus(model, cfg, 250, np.random.default_rng(3),
                                     "cpu", bulk=64)
    ids = np.random.default_rng(3)
    parts = [ids.integers(0, cfg.item_vocab, (n, 2, 4)).astype(np.int32)
             for n in (64, 64, 64, 58)]
    b = tt.item_embedding(model, torch.from_numpy(np.concatenate(parts)),
                          cfg).detach()
    _close(a.numpy(), b.numpy(), 1e-6)


def test_launcher_recsys_smoke_on_cpu():
    from repro_torch.launch.train import _recsys_smoke

    r = _recsys_smoke(device="cpu")
    assert r["finite"] and r["kernel_matches_reference"] and r["launches_ok"]
    assert r["launches"] == {}
    assert np.isfinite(r["loss"]) and r["grad_norm"] > 0


def test_launcher_recsys_smoke_matches_jax_smoke_at_the_same_weights():
    """The smoke's loss at the reference smoke's own ids and weights."""
    from repro.configs import two_tower_retrieval as jconf
    import dataclasses

    jsmall = dataclasses.replace(
        jconf.CONFIG, embed_dim=16, tower_mlp=(32, 16), bag_size=4,
        user_vocab=1000, item_vocab=1000)
    jp = jt.init_two_tower(jax.random.PRNGKey(0), jsmall)
    u = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (8, 8, 4), 0,
                                      1000)).astype(np.int32)
    i = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (8, 4, 4), 0,
                                      1000)).astype(np.int32)
    jl, _ = jax.jit(
        lambda p: jt.two_tower_loss(p, jnp.asarray(u), jnp.asarray(i), jsmall)
    )(jp)
    model = two_tower_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    (loss, _), grads = tt.two_tower_value_and_grad(
        model, torch.from_numpy(u), torch.from_numpy(i), SMOKE)
    _close(float(loss), float(jl), 1e-4)


def test_launcher_refuses_recsys_without_smoke(capsys):
    from repro_torch.launch.train import main

    for argv in (["--arch", "two-tower-retrieval"],
                 ["--arch", "two-tower-retrieval", "--offload"]):
        with pytest.raises(SystemExit) as ei:
            main(argv)
        assert ei.value.code == 2
    assert "only --smoke is ported" in capsys.readouterr().out
