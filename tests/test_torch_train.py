"""The port's optimizer, checkpoints, epoch loop and training launcher, on
the CPU, against the reference package where it has a counterpart.

- ``adamw_update`` vs the reference one on the same arrays: parameters and
  state within 1e-6 relative over 5 steps (float32 elementwise math in both;
  XLA may fuse the expression, ATen runs it op by op);
- checkpoints: round trip of a module tree and optimizer state onto the
  template's device and dtype, a torn save skipped, stray ``.tmp_*`` dirs
  collected;
- ``run_epoch_loop`` over the port's engine: an in-process crash and a
  SIGKILL mid-epoch both resume from the last epoch checkpoint and end
  bitwise equal to an uninterrupted run;
- 3 epochs of the port's engine + AdamW vs the reference engine + AdamW:
  the loss trajectory within 1e-4 relative;
- the ``launch.train`` smoke passes its checks; the launcher's exit codes.
"""
import json
import os
import signal
import subprocess
import sys
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Counters as JCounters
from repro.core import HostCache as JHostCache
from repro.core import SSOEngine as JSSOEngine
from repro.core import StorageTier as JStorageTier
from repro.core import build_plan as jax_build_plan
from repro.graph import (
    gcn_norm_coeffs, kronecker_graph, switching_aware_partition,
)
from repro.graph.csr import add_self_loops
from repro.graph.synthetic import random_features, random_labels
from repro.models.gnn.layers import get_gnn as jax_get_gnn
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.runtime import PipelineConfig as JPipelineConfig

from repro_torch.core.cache import HostCache
from repro_torch.core.counters import Counters
from repro_torch.core.engine import SSOEngine
from repro_torch.core.plan import build_plan
from repro_torch.core.storage import StorageTier
from repro_torch.graph.csr import CSRGraph
from repro_torch.launch import train as launch_train
from repro_torch.models.gnn.layers import get_gnn
from repro_torch.optim import adamw_init, adamw_update, sgd_update
from repro_torch.params import params_from_jax, params_to_numpy
from repro_torch.runtime import PipelineConfig
from repro_torch.train import (
    EpochLoopConfig, latest_checkpoint, restore_checkpoint, run_epoch_loop,
    save_checkpoint,
)

DIMS = [16, 24, 8]
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30)


# ------------------------------------------------------------------- adamw
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_matches_reference(weight_decay, rng):
    shapes = {"w": (6, 5), "b": (5,)}
    p_np = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    jo, to = jax_adamw_init(jp), adamw_init(tp)
    for _ in range(5):
        g_np = {k: rng.standard_normal(s).astype(np.float32)
                for k, s in shapes.items()}
        jp, jo = jax_adamw_update({k: jnp.asarray(v) for k, v in g_np.items()},
                                  jp, jo, lr=1e-2, weight_decay=weight_decay)
        tp, to = adamw_update({k: torch.from_numpy(v) for k, v in g_np.items()},
                              tp, to, lr=1e-2, weight_decay=weight_decay)
    assert int(to["step"]) == int(jo["step"]) == 5
    assert to["step"].dtype == torch.int32
    for k in shapes:
        assert _rel(jp[k], tp[k]) <= 1e-6
        assert _rel(jo["m"][k], to["m"][k]) <= 1e-6
        assert _rel(jo["v"][k], to["v"][k]) <= 1e-6


def test_optimizers_on_modules_are_functional(rng):
    params = get_gnn("gcn").init(torch.Generator().manual_seed(0), 8, 8, 4, 2,
                                 device="cpu")
    before = [t.clone() for t in params.parameters()]
    grads = [{n: torch.ones_like(p) for n, p in layer.named_parameters()}
             for layer in params]
    new, st = adamw_update(grads, params, adamw_init(params), lr=0.5)
    assert all(torch.equal(a, b) for a, b in zip(before, params.parameters()))
    assert type(new) is type(params)
    for a, b in zip(before, new.parameters()):
        torch.testing.assert_close(b, a - 0.5, rtol=0, atol=1e-6)
    new = sgd_update(grads, params, lr=0.25)
    for a, b in zip(before, new.parameters()):
        torch.testing.assert_close(b, a - 0.25, rtol=0, atol=0)
    with pytest.raises(ValueError, match="leaves"):
        adamw_update(grads[:1], params, st)


# ------------------------------------------------------------- checkpoints
def _module_params(seed=0):
    return get_gnn("gcn").init(torch.Generator().manual_seed(seed), 8, 12, 4,
                               2, device="cpu")


def test_checkpoint_round_trip_onto_template(tmp_path):
    params = _module_params(0)
    opt = adamw_init(params)
    opt["step"] += 3
    path = save_checkpoint(str(tmp_path), 7, params, opt,
                           extra={"losses": [1.5, 1.25]})
    assert latest_checkpoint(str(tmp_path)) == path
    tpl = _module_params(1)
    got, got_opt, step, extra = restore_checkpoint(path, tpl, adamw_init(tpl))
    assert step == 7 and extra == {"losses": [1.5, 1.25]}
    for a, b in zip(params.parameters(), got.parameters()):
        assert torch.equal(a, b)
    # the template is untouched; the restored leaves follow its dtype/device
    assert not torch.equal(tpl[0].lin.weight, got[0].lin.weight)
    assert got_opt["step"].dtype == torch.int32 and int(got_opt["step"]) == 3
    # numpy leaves restore as numpy
    arrs = {"w": np.arange(6, dtype=np.float64)}
    p2 = save_checkpoint(str(tmp_path), 8, arrs)
    back, _, _, _ = restore_checkpoint(p2, {"w": np.zeros(6)})
    np.testing.assert_array_equal(back["w"], arrs["w"])


def test_torn_save_skipped_and_tmp_collected(tmp_path):
    d = str(tmp_path)
    params = _module_params(0)
    good = save_checkpoint(d, 1, params)
    # a torn later save: manifest references a payload that is missing
    torn = os.path.join(d, "step_0000000002")
    os.makedirs(torn)
    with open(os.path.join(torn, "manifest.json"), "w") as f:
        json.dump({"step": 2, "leaves": {"params:0.lin.weight": {}}}, f)
    os.makedirs(os.path.join(d, ".tmp_stranded"))
    assert latest_checkpoint(d) == good
    save_checkpoint(d, 3, params)
    names = sorted(os.listdir(d))
    assert names == ["step_0000000001", "step_0000000003"]


# -------------------------------------------------------------- epoch loop
@pytest.fixture(scope="module")
def small():
    g = add_self_loops(kronecker_graph(600, 6, seed=0))
    parts = switching_aware_partition(g, 4, max_iters=6, seed=0).parts
    ew = gcn_norm_coeffs(g)
    jplan = jax_build_plan(g, parts, 4, edge_weight=ew)
    pg = CSRGraph(g.indptr.copy(), g.indices.copy(), g.n_nodes)
    plan = build_plan(pg, parts, 4, edge_weight=ew, device="cpu")
    X = random_features(g.n_nodes, DIMS[0], 0)[jplan.ro.perm]
    Y = random_labels(g.n_nodes, DIMS[-1], 0)[jplan.ro.perm]
    jparams = jax_get_gnn("gcn").init(jax.random.PRNGKey(0), DIMS[0],
                                      DIMS[1], DIMS[-1], 2)
    jparams = [jax.tree_util.tree_map(np.asarray, p) for p in jparams]
    return jplan, plan, X, Y, jparams


def _port_loop(small, epochs, ckpt=None, crash_at=None, depth=2):
    _, plan, X, Y, jparams = small
    c = Counters()
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    eng = SSOEngine(get_gnn("gcn"), plan, DIMS, st, HostCache(1 << 20, st, c),
                    c, device="cpu", pipeline=PipelineConfig(depth=depth))
    eng.initialize(X)

    def epoch_fn(p, e):
        if e == crash_at:
            raise RuntimeError("simulated crash")
        return eng.run_epoch(p, Y)

    def update_fn(g, p, o):
        return adamw_update(g, p, o, lr=1e-2)

    params = params_from_jax(jparams, device="cpu")
    try:
        return run_epoch_loop(
            EpochLoopConfig(epochs=epochs, ckpt_dir=ckpt), params,
            adamw_init(params), epoch_fn, update_fn, log_fn=lambda s: None,
        )
    finally:
        eng.close()
        st.close()


def test_epoch_loop_resumes_bit_identical_after_crash(small, tmp_path):
    ref, ref_opt, ref_losses = _port_loop(small, 3)
    d = str(tmp_path)
    with pytest.raises(RuntimeError, match="simulated"):
        _port_loop(small, 3, ckpt=d, crash_at=2)
    assert latest_checkpoint(d).endswith("step_0000000002")
    got, got_opt, losses = _port_loop(small, 3, ckpt=d)   # resumes at 2
    assert losses == ref_losses
    for a, b in zip(ref.parameters(), got.parameters()):
        assert torch.equal(a, b)
    assert int(got_opt["step"]) == 3


def test_port_vs_reference_three_epochs_of_adamw(small):
    jplan, _, X, Y, jparams = small
    c = JCounters()
    st = JStorageTier(tempfile.mkdtemp(), counters=c)
    eng = JSSOEngine(jax_get_gnn("gcn"), jplan, DIMS, st,
                     JHostCache(1 << 20, st, c), c,
                     pipeline=JPipelineConfig(depth=2, kernels="reference"))
    eng.initialize(X)
    jp, jo, jlosses = jparams, jax_adamw_init(jparams), []
    for _ in range(3):
        loss, grads = eng.run_epoch(jp, Y)
        jp, jo = jax_adamw_update(grads, jp, jo, lr=1e-2)
        jlosses.append(loss)
    eng.close()
    st.close()
    params, _, losses = _port_loop(small, 3)
    assert len(losses) == 3 and jlosses[0] != jlosses[-1]
    for a, b in zip(jlosses, losses):
        assert abs(a - b) <= 1e-4 * max(1.0, abs(a))
    for jl, tl in zip(jp, params_to_numpy(params)):
        assert _rel(jl["lin"]["w"], tl["lin"]["w"]) <= 1e-4


_VICTIM = textwrap.dedent("""
    import sys, time
    import torch
    from repro_torch.train.loop import EpochLoopConfig, run_epoch_loop

    ckpt, mode = sys.argv[1], sys.argv[2]

    def epoch_fn(p, e):
        if mode == "hang" and e >= 2:
            print("READY", flush=True)     # parent SIGKILLs us here,
            time.sleep(120)                # mid-epoch, after ckpt(2)
        return float((p["w"] ** 2).sum()), {"w": 2.0 * p["w"]}

    def update_fn(g, p, o):
        return {"w": p["w"] - 0.1 * g["w"]}, o

    params = {"w": torch.arange(8, dtype=torch.float64)}
    params, _, losses = run_epoch_loop(
        EpochLoopConfig(epochs=5, ckpt_dir=ckpt, ckpt_every=1),
        params, None, epoch_fn, update_fn, log_fn=lambda s: None)
    torch.save(params["w"], ckpt + "/final.pt")
""")


def test_kill_mid_epoch_resume_bit_identical(tmp_path):
    """SIGKILL a training process mid-epoch; a restarted process resumes
    from the last atomic checkpoint and finishes bit-identical to a run
    that was never killed."""
    script = tmp_path / "victim.py"
    script.write_text(_VICTIM)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.abspath(SRC) + os.pathsep + \
        env.get("PYTHONPATH", "")
    d_kill = str(tmp_path / "ckpt_kill")
    proc = subprocess.Popen([sys.executable, str(script), d_kill, "hang"],
                            stdout=subprocess.PIPE, text=True, env=env)
    try:
        assert "READY" in proc.stdout.readline()   # inside epoch 2
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
        assert proc.returncode != 0
        assert not os.path.exists(os.path.join(d_kill, "final.pt"))
        subprocess.run([sys.executable, str(script), d_kill, "run"],
                       check=True, timeout=120, env=env)
    finally:
        if proc.poll() is None:
            proc.kill()
    d_ref = str(tmp_path / "ckpt_ref")
    subprocess.run([sys.executable, str(script), d_ref, "run"], check=True,
                   timeout=120, env=env)
    got = torch.load(os.path.join(d_kill, "final.pt"))
    ref = torch.load(os.path.join(d_ref, "final.pt"))
    assert torch.equal(got, ref)


# ---------------------------------------------------------------- launcher
@pytest.mark.parametrize("kernels,mode", [
    ("auto", "regather"), ("kernel-fused", "regather"),
    ("kernel", "snapshot"),
])
def test_train_smoke_passes_all_checks(kernels, mode):
    r = launch_train._train_smoke("gcn", 2, kernels=kernels, mode=mode,
                                  n_nodes=800, epochs=2, device="cpu")
    assert r["finite"] and r["pipeline_matches_serial"]
    assert r["dense_loss_rel_err"] <= 1e-4
    assert r["dense_grad_rel_err"] <= 5e-4
    assert sorted(r["runs"]) == [0, 2]
    for run in r["runs"].values():
        assert len(run["losses"]) == len(run["grads"]) == 2
        assert run["losses"][1] != run["losses"][0]   # AdamW moved them
        assert run["counters"].host_scatter_bytes > 0


def test_dense_check_counts_kink_flips_past_its_tolerance(monkeypatch):
    """Past ``DENSE_GRAD_TOL`` the dense check counts the kinks whose branch
    a float32 forward of the oracle gets the other way; ``dense_ok`` then
    reads the float64 oracle on the float32 branches, where there are any
    (none at this size)."""
    monkeypatch.setattr(launch_train, "DENSE_GRAD_TOL", 0.0)
    r = launch_train._train_smoke("gat", 0, n_nodes=400, device="cpu")
    assert r["dense_grad_rel_err"] > 0.0
    assert r["kink_flips"] == 0
    assert "dense_grad_rel_err_f32_branches" not in r
    assert not launch_train.dense_ok(r)
    monkeypatch.undo()
    assert launch_train.dense_ok(r)
    assert not launch_train.dense_ok(dict(r, dense_loss_rel_err=2e-4))
    assert launch_train.dense_ok(dict(
        r, dense_grad_rel_err=3e-3, kink_flips=1,
        dense_grad_rel_err_f32_branches=1e-6))
    assert not launch_train.dense_ok(dict(r, dense_grad_rel_err=3e-3))


def test_launcher_exit_codes(monkeypatch, capsys):
    with pytest.raises(SystemExit) as ei:
        launch_train.main(["--arch", "mixtral-8x7b", "--offload"])
    assert ei.value.code == 2
    assert "requires a GNN arch" in capsys.readouterr().out
    # a GNN id's full configuration hands over to its dry run, which runs
    # on the card unless --device says otherwise
    for arch in ("pna", "gcn-cora"):
        with pytest.raises(SystemExit) as ei:
            launch_train.main(["--arch", arch])
        assert ei.value.code == 1
        out = capsys.readouterr().out
        assert f"{arch}: the full configuration runs on the production " \
               f"mesh; its dry run (full_graph_sm, 16x16)" in out
        assert "CUDA is unavailable" in out
    # the real smoke, on the CPU (the launcher runs on the card unless
    # --device says otherwise)
    with pytest.raises(SystemExit) as ei:
        launch_train.main(["--arch", "gcn-cora", "--offload",
                           "--pipeline-depth", "1", "--device", "cpu"])
    assert ei.value.code == 0
    assert "pipeline_matches_serial': True" in capsys.readouterr().out
    monkeypatch.setattr(launch_train, "_train_smoke",
                        lambda *a, **k: dict(finite=False, runs={},
                                             pipeline_matches_serial=True))
    with pytest.raises(SystemExit) as ei:
        launch_train.main(["--arch", "gcn-cora", "--offload"])
    assert ei.value.code == 1


def test_launcher_list_prints_the_reference_lines(monkeypatch, capsys):
    """``--list`` prints the reference's ``--list`` lines of the ids both
    registries hold (the reference's needs an ``--arch``; it ignores it)."""
    from repro.launch import train as jax_launch_train
    from repro_torch.configs import REGISTRY

    monkeypatch.setattr(sys, "argv", ["train", "--arch", "gcn-cora",
                                      "--list"])
    jax_launch_train.main()
    ref = capsys.readouterr().out.splitlines()
    launch_train.main(["--list"])
    got = capsys.readouterr().out.splitlines()
    assert got == [line for line in ref if line.split()[0] in REGISTRY]
    assert [line.split()[0] for line in got] == list(REGISTRY)


def test_launcher_resolves_gnn_archs_through_the_registry(monkeypatch,
                                                          capsys):
    """A GNN arch's family is its ``GNNArch.model`` (the reference takes
    the id's first word, which is not a family for ``graphsage-reddit``):
    ``--smoke`` runs ``ArchSpec.smoke`` and ``--offload`` the SSO engine
    smoke, on the CPU with ``--device cpu``; a full config runs its dry
    run (exit 0 and its report line)."""
    from repro_torch.configs import REGISTRY
    from repro_torch.launch.infer import GNN_ARCHS

    assert GNN_ARCHS == {n: a.config.model for n, a in REGISTRY.items()
                         if a.family == "gnn"}
    assert GNN_ARCHS["graphsage-reddit"] == "sage"
    for argv, say in (
            (["--arch", "gcn-cora", "--smoke", "--device", "cpu"],
             "gcn-cora smoke: {'loss'"),
            (["--arch", "graphsage-reddit", "--offload", "--pipeline-depth",
              "1", "--device", "cpu"],
             "pipeline_matches_serial': True")):
        with pytest.raises(SystemExit) as ei:
            launch_train.main(argv)
        assert ei.value.code == 0
        assert say in capsys.readouterr().out
    with pytest.raises(SystemExit) as ei:
        launch_train.main(["--arch", "graphcast", "--device", "cpu"])
    assert ei.value.code == 0
    assert "[ok] graphcast full_graph_sm 16x16" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--arch", "pna", "--smoke"])
