"""The GCNII reference (``reference/gcnii.py``) against an independent
dense computation, autograd and ``torch.optim.Adam`` in float64 at a tiny
size, as ``test_perfbench_reference.py`` holds GCN and GAT; and the two
limits files this configuration's cells brought hold the numbers the
comparison makes."""
import json
import math

import numpy as np
import pytest
import torch

from perfbench import compare, harness, reference
from perfbench.reference import gcnii

OPTIM = {"lr": 0.01, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.0}
CFG = {"model": "gcnii", "dims": [12] + [8] * 4 + [3], "alpha": 0.1,
       "lambda": 0.4, "n_nodes": 160, "avg_degree": 5}


def _inputs(seed=5):
    traffic = {"graph": {"structure_seed": 0, "partition_seed": 0,
                         "a": 0.57, "b": 0.19, "c": 0.19}}
    return harness.make_inputs(CFG, traffic, seed, torch.device("cpu"))


def _dense_forward(params, x, inp):
    """GCNII with a dense normalised adjacency, written out per layer."""
    n = inp.n_nodes
    dst = np.repeat(np.arange(n), np.diff(inp.indptr))
    adj = np.zeros((n, n))
    adj[dst, inp.indices] = 1.0
    a = torch.from_numpy(adj)
    deg = a.sum(1).clamp_min(1.0)
    norm = a / torch.sqrt(deg[:, None] * deg[None, :])
    h0 = torch.relu(x @ params[0]["lin.weight"].T + params[0]["lin.bias"])
    h = h0
    for l in range(1, len(params) - 1):
        b = math.log(CFG["lambda"] / l + 1.0)
        s = (1 - CFG["alpha"]) * (norm @ h) + CFG["alpha"] * h0
        h = torch.relu(s @ ((1 - b) * torch.eye(s.shape[1], dtype=s.dtype)
                            + b * params[l]["w"]))
    return h @ params[-1]["lin.weight"].T + params[-1]["lin.bias"]


def test_forward_matches_dense():
    inp = _inputs()
    got = reference.embeddings(CFG, inp, "cpu")
    params = reference._params(inp.weights, 5, torch.float64, grad=False)
    want = _dense_forward(params, torch.from_numpy(inp.x).double(), inp)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10, atol=1e-12)


def test_three_adam_steps_match_dense():
    inp = _inputs()
    got = reference.train_readings(CFG, inp, OPTIM, 3, "cpu")
    params = reference._params(inp.weights, 5, torch.float64, grad=True)
    flat = {f"{i}.{k}": v for i, p in enumerate(params) for k, v in p.items()}
    p0 = {k: v.detach().clone() for k, v in flat.items()}
    opt = torch.optim.Adam(list(flat.values()), lr=OPTIM["lr"],
                           betas=(OPTIM["b1"], OPTIM["b2"]), eps=OPTIM["eps"])
    x = torch.from_numpy(inp.x).double()
    y = torch.from_numpy(inp.y.astype(np.int64))
    for t in range(3):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(
            _dense_forward(params, x, inp), y)
        loss.backward()
        assert got["losses"][t] == pytest.approx(loss.item(), rel=1e-10)
        if t == 0:
            for k, v in flat.items():
                assert got["grad1"][k] == pytest.approx(
                    float(v.grad.norm()), rel=1e-8, abs=1e-14), k
        opt.step()
    for k, v in flat.items():
        assert got["change"][k] == pytest.approx(
            float((v.detach() - p0[k]).norm()), rel=1e-8, abs=1e-14), k


def test_param_shapes_are_the_programs():
    from repro_torch.models.gnn.layers import get_gnn

    cfg = json.loads((harness.BENCH_DIR / "configs" /
                      "gcnii-igbm-16l.json").read_text())
    dims = cfg["dims"]
    mine = {k: s for k, s, _ in gcnii.param_init(cfg)}
    prog = get_gnn("gcnii").init(torch.Generator(), dims[0], dims[1],
                                 dims[-1], len(dims) - 1, device="meta")
    theirs = {f"{i}.{k}": tuple(p.shape) for i, layer in enumerate(prog)
              for k, p in layer.named_parameters()}
    assert mine == theirs


def test_flops_count_aggregations_and_products():
    n, e = 10, 40
    # the dense input layer, three convolutions, the dense output layer
    want = (2 * n * 12 * 8 + 3 * (2 * e * 8 + 2 * n * 8 * 8)
            + 2 * n * 8 * 3)
    assert gcnii.forward_flops(CFG, n, e) == want


@pytest.mark.parametrize("cell", ["gcnii-igbm-16l.train_spill",
                                  "gcn-igbm-3l.train_resident"])
def test_limits_hold_the_compared_numbers(cell):
    limits = json.loads((harness.BENCH_DIR / "limits" /
                         f"{cell}.json").read_text())
    readings = {"losses": [1.0], "grad1": {"a": 1.0, "b": 2.0},
                "change": {"a": 1.0, "b": 2.0}}
    numbers = compare.train_numbers(readings, readings)
    assert set(limits) == set(numbers)
    assert all(isinstance(v, float) and v > 0 for v in limits.values())
    assert compare.judge(numbers, limits)[0]
