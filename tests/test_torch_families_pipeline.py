"""The five families beyond GCN inside the port, and GAT's serving path vs
the reference, on the CPU (setup of ``tests/test_torch_families.py``):

- pipelined (depth 2, 2 gather workers, transfer stage) == serial BITWISE
  in regather and snapshot mode, and for GAT in the kernel modes;
- AdamW and checkpoints over 0-d parameters (GIN ``eps``, PNA
  ``log_mean_deg``): the port's update equals the reference's on the same
  engine gradients within 1e-6 (same formula and order), and a checkpoint
  restores every leaf bitwise;
- GAT's ``OffloadedInference`` table vs the reference's within 1e-4
  max-relative (float32 reassociation over two layers), ``kernel`` ==
  ``reference`` and pipelined == serial bitwise, ``kernel-fused`` within
  1e-4;
- the launchers' train and infer smokes pass every check for each family.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Counters as JCounters
from repro.core import HostCache as JHostCache
from repro.core import StorageTier as JStorageTier
from repro.infer import OffloadedInference as JOffloadedInference
from repro.models.gnn.layers import get_gnn as jax_get_gnn
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.runtime import PipelineConfig as JPipelineConfig

from repro_torch.core.cache import HostCache
from repro_torch.core.counters import Counters
from repro_torch.core.storage import StorageTier
from repro_torch.infer import OffloadedInference
from repro_torch.launch.infer import _infer_smoke
from repro_torch.launch.train import _train_smoke
from repro_torch.models.gnn.layers import get_gnn
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.params import grads_to_jax, params_from_jax, params_to_numpy
from repro_torch.runtime import PipelineConfig
from repro_torch.train import restore_checkpoint, save_checkpoint

from test_torch_families import (
    DIMS, FAMILIES, assert_same, jax_params, make_setup, port_run,
)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-30)


@pytest.fixture(scope="module")
def setup():
    return make_setup()


@pytest.fixture(scope="module")
def serial(setup):
    _, plan, X, Y = setup
    memo = {}

    def get(model, mode, kernels="reference"):
        if (model, mode, kernels) not in memo:
            memo[model, mode, kernels] = port_run(
                model, plan, X, Y,
                params_from_jax(jax_params(model), device="cpu"),
                mode=mode, kernels=kernels)
        return memo[model, mode, kernels]

    return get


@pytest.mark.parametrize("mode", ["regather", "snapshot"])
@pytest.mark.parametrize("model", FAMILIES)
def test_family_pipelined_equals_serial_bitwise(setup, serial, model, mode):
    _, plan, X, Y = setup
    got = port_run(model, plan, X, Y,
                   params_from_jax(jax_params(model), device="cpu"),
                   mode=mode, depth=2, workers=2)
    assert_same(serial(model, mode), got)
    assert got[2].stage_busy_seconds.get("gather", 0.0) > 0.0


@pytest.mark.parametrize("kernels", ["kernel", "kernel-fused"])
def test_gat_kernel_modes_pipelined_equals_serial_bitwise(setup, serial,
                                                          kernels):
    _, plan, X, Y = setup
    got = port_run("gat", plan, X, Y,
                   params_from_jax(jax_params("gat"), device="cpu"),
                   depth=2, workers=2, kernels=kernels)
    assert_same(serial("gat", "regather", kernels), got)


@pytest.mark.parametrize("model", ["gin", "pna"])
def test_adamw_and_checkpoint_over_0d_params(serial, model, tmp_path):
    jp = jax_params(model)
    params = params_from_jax(jp, device="cpu")
    _, grads, _ = serial(model, "regather")
    jgrads = grads_to_jax(grads)
    to, jo = adamw_init(params), jax_adamw_init(jp)
    tp = params
    for _ in range(3):
        jp, jo = jax_adamw_update(jax.tree.map(jnp.asarray, jgrads), jp, jo,
                                  lr=1e-2, weight_decay=0.01)
        tp, to = adamw_update(grads, tp, to, lr=1e-2, weight_decay=0.01)
    zero_d = [n for n, p in tp[0].named_parameters() if p.dim() == 0]
    assert zero_d == [{"gin": "eps", "pna": "log_mean_deg"}[model]]
    assert to["m"][f"0.{zero_d[0]}"].shape == ()
    for w, g in zip(jax.tree.leaves(jp),
                    jax.tree.leaves(params_to_numpy(tp))):
        assert np.shape(w) == np.shape(g)
        assert _rel(w, g) <= 1e-6
    path = save_checkpoint(str(tmp_path), 3, tp, to)
    tpl = get_gnn(model).init(torch.Generator().manual_seed(9), DIMS[0],
                              DIMS[1], DIMS[-1], 2, device="cpu")
    got, got_opt, step, _ = restore_checkpoint(path, tpl, adamw_init(tpl))
    assert step == 3 and int(got_opt["step"]) == 3
    for a, b in zip(tp.parameters(), got.parameters()):
        assert a.shape == b.shape and torch.equal(a, b)
    for k in ("m", "v"):
        assert to[k].keys() == got_opt[k].keys()
        for n in to[k]:
            assert torch.equal(to[k][n], got_opt[k][n]), (k, n)


def _infer(plan, X, params, depth, kernels, jax_side=False):
    if jax_side:
        c = JCounters()
        st = JStorageTier(tempfile.mkdtemp(), counters=c)
        inf = JOffloadedInference(
            jax_get_gnn("gat"), plan, DIMS, st,
            JHostCache(4096 << 10, st, c), c,
            pipeline=JPipelineConfig(depth=depth, kernels="reference"))
    else:
        c = Counters()
        st = StorageTier(tempfile.mkdtemp(), counters=c)
        inf = OffloadedInference(
            get_gnn("gat"), plan, DIMS, st, HostCache(4096 << 10, st, c), c,
            pipeline=PipelineConfig(depth=depth, kernels=kernels),
            device="cpu")
    inf.initialize(X)
    name = inf.run(params)
    emb = st.read_rows(name, 0, plan.n_nodes)
    inf.close()
    st.close()
    return emb, c


def test_gat_offloaded_inference_matches_reference(setup):
    jplan, plan, X, _ = setup
    jp = jax_params("gat")
    want, jc = _infer(jplan, X, jp, 0, None, jax_side=True)
    params = params_from_jax(jp, device="cpu")
    outs = {}
    for kernels in ("reference", "kernel", "kernel-fused"):
        for depth in (0, 2):
            outs[kernels, depth], c = _infer(plan, X, params, depth, kernels)
    ref, c = _infer(plan, X, params, 0, "reference")
    assert np.all(np.isfinite(ref))
    assert _rel(want, ref) <= 1e-4
    assert c.storage_read_bytes == jc.storage_read_bytes
    assert c.host_gather_bytes == jc.host_gather_bytes
    for (kernels, depth), emb in outs.items():
        if kernels == "kernel-fused":
            assert np.array_equal(emb, outs["kernel-fused", 0])
            assert _rel(ref, emb) <= 1e-4
        else:
            assert np.array_equal(emb, ref), (kernels, depth)


@pytest.mark.parametrize("model", FAMILIES)
def test_launcher_smokes_pass_for_family(model):
    r = _train_smoke(model, 2, n_nodes=600, device="cpu")
    assert r["finite"] and r["pipeline_matches_serial"]
    assert r["dense_loss_rel_err"] <= 1e-4
    assert r["dense_grad_rel_err"] <= 5e-4
    kernels = "kernel-fused" if model == "gat" else "auto"
    r = _infer_smoke(model, 2, n_nodes=600, kernels=kernels, device="cpu")
    assert r["finite"] and r["pipeline_matches_serial"]
    assert r["serve_matches_table"] and r["serve_matches_dense"]

