"""The plain reference against an independent dense computation: a dense
adjacency (GCN) or a dense masked attention (GAT), autograd and
``torch.optim.Adam`` in float64, at a tiny size."""
import numpy as np
import pytest
import torch

from perfbench import harness, reference
from perfbench.reference import gat, gcn

OPTIM = {"lr": 0.01, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.0}


def _inputs(model, seed=5, n=160):
    cfg = {"model": model, "dims": [12, 8, 8, 3], "heads": 4,
           "n_nodes": n, "avg_degree": 5}
    traffic = {"graph": {"structure_seed": 0, "partition_seed": 0, "a": 0.57, "b": 0.19, "c": 0.19}}
    return cfg, harness.make_inputs(cfg, traffic, seed, torch.device("cpu"))


def _dense_forward(model, params, x, inp, cfg):
    n = inp.n_nodes
    dst = np.repeat(np.arange(n), np.diff(inp.indptr))
    adj = np.zeros((n, n))
    adj[dst, inp.indices] = 1.0
    a = torch.from_numpy(adj)
    h = x
    for i, p in enumerate(params):
        last = i == len(params) - 1
        if model == "gcn":
            deg = a.sum(1)
            norm = a / torch.sqrt(deg[:, None] * deg[None, :])
            h = norm @ h @ p["lin.weight"].T + p["lin.bias"]
            h = h if last else torch.relu(h)
        else:
            d_in, nh, dh = p["w"].shape
            z = (h @ p["w"].reshape(d_in, nh * dh)).reshape(n, nh, dh)
            es = torch.einsum("nhe,he->nh", z, p["a_src"])
            ed = torch.einsum("nhe,he->nh", z, p["a_dst"])
            s = ed[:, None, :] + es[None, :, :]                 # (dst, src, h)
            s = torch.where(s >= 0, s, 0.2 * s)
            s = s.masked_fill(a[:, :, None] == 0, -torch.inf)
            att = torch.softmax(s, dim=1)
            h = torch.einsum("ijh,jhe->ihe", att, z).reshape(n, nh * dh)
            h = h + p["b"]
            h = h if last else torch.nn.functional.elu(h)
    return h


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_forward_matches_dense(model):
    cfg, inp = _inputs(model)
    got = reference.embeddings(cfg, inp, "cpu")
    params = reference._params(inp.weights, 3, torch.float64, grad=False)
    want = _dense_forward(model, params, torch.from_numpy(inp.x).double(),
                          inp, cfg)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_three_adam_steps_match_dense(model):
    cfg, inp = _inputs(model)
    got = reference.train_readings(cfg, inp, OPTIM, 3, "cpu")
    params = reference._params(inp.weights, 3, torch.float64, grad=True)
    flat = {f"{i}.{k}": v for i, p in enumerate(params) for k, v in p.items()}
    p0 = {k: v.detach().clone() for k, v in flat.items()}
    opt = torch.optim.Adam(list(flat.values()), lr=OPTIM["lr"],
                           betas=(OPTIM["b1"], OPTIM["b2"]), eps=OPTIM["eps"])
    x = torch.from_numpy(inp.x).double()
    y = torch.from_numpy(inp.y.astype(np.int64))
    for t in range(3):
        opt.zero_grad()
        loss = torch.nn.functional.cross_entropy(
            _dense_forward(model, params, x, inp, cfg), y)
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


def test_gcn_param_shapes_are_the_programs():
    from repro_torch.models.gnn.layers import get_gnn

    for model, fam in (("gcn", gcn), ("gat", gat)):
        cfg = {"dims": [1024, 256, 256, 19], "heads": 4}
        mine = {k: s for k, s, _ in fam.param_init(cfg)}
        prog = get_gnn(model).init(torch.Generator(), 1024, 256, 19, 3,
                                   device="meta")
        theirs = {f"{i}.{k}": tuple(p.shape) for i, layer in enumerate(prog)
                  for k, p in layer.named_parameters()}
        assert mine == theirs


def test_half_batch_fault_moves_the_loss():
    cfg, inp = _inputs("gcn")
    a = reference.train_readings(cfg, inp, OPTIM, 1, "cpu")
    b = reference.train_readings(cfg, inp, OPTIM, 1, "cpu", half_batch=True)
    assert a["losses"][0] != b["losses"][0]
