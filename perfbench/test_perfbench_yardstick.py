"""The byte and FLOP arithmetic: on a hand-sized plan, against the
program's launches on a real plan, and the GCN FLOPs against the
program's cost model."""
import types

import numpy as np
import pytest
import torch

from perfbench import yardstick
from perfbench.reference import gat, gcn


def _unit(n_req, r_pad, req_global, req_part_ptr, req_parts):
    return types.SimpleNamespace(
        n_req=n_req, r_pad=r_pad, req_global=np.asarray(req_global),
        req_part_ptr=np.asarray(req_part_ptr), req_parts=np.asarray(req_parts))


def test_launches_and_bytes_by_hand():
    # two partitions of 4 nodes: [0, 4) and [4, 8)
    ro = types.SimpleNamespace(part_ptr=np.array([0, 4, 8]))
    u0 = _unit(5, 8, [0, 1, 2, 3, 6], [0, 4, 5], [0, 1])   # q0 a run, q1 one row
    u1 = _unit(6, 8, [1, 3, 4, 5, 6, 7], [0, 2, 6], [0, 1])  # q0 gapped, q1 a run
    plan = types.SimpleNamespace(units=[u0, u1], ro=ro)
    dims = [8, 4, 2]
    got = yardstick.kernel_launches(plan, dims, "train")
    # gather_rows: 2 units x 2 layers x (forward, regather)
    gb = 0.0
    for u in (u0, u1):
        for d in dims[:2]:
            gb += 2 * (4 * (u.n_req + 1) * d + 4 * 8 + 4 * 8 * d)
    assert got["gather_rows"] == (8, gb)
    # scatter_add: layer 1 only; u0's q1 (row 6 alone) is a run of one,
    # u1's q0 (rows 1, 3) is not a run
    assert got["scatter_add"] == (1, 3 * 4 * 2 * 4 + 4 * 2)
    ref = yardstick.kernel_launches(plan, dims, "refresh")
    assert ref == {"gather_rows": (4, gb / 2)}


def test_gcn_flops_match_the_programs_cost_model():
    from repro_torch.core.costmodel import gnn_epoch_flops

    cfg = {"dims": [1024, 256, 256, 19]}
    n, e = 65536, 1_460_152
    assert yardstick.step_flops(dict(cfg, model="gcn"), "train", n, e) == \
        pytest.approx(gnn_epoch_flops(n, e, cfg["dims"]), rel=1e-12)
    assert yardstick.step_flops(dict(cfg, model="gcn"), "refresh", n, e) == \
        pytest.approx(gnn_epoch_flops(n, e, cfg["dims"]) / 3, rel=1e-12)


def test_gat_flops_by_hand():
    cfg = {"dims": [8, 4, 3], "heads": 2, "model": "gat"}
    n, e = 10, 30
    l0 = 2 * n * 8 * 4 + 4 * n * 4 + 7 * e * 2 + 2 * e * 4 + n * 4
    l1 = 2 * n * 4 * 3 + 4 * n * 3 + 7 * e * 1 + 2 * e * 3 + n * 3
    assert gat.forward_flops(cfg, n, e) == l0 + l1
    assert gcn.forward_flops(cfg, n, e) == \
        2 * e * 8 + 2 * n * 8 * 4 + 2 * e * 4 + 2 * n * 4 * 3


def test_peaks_by_card_name():
    assert yardstick.peaks_for("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] \
        == 3.35e12
    assert yardstick.peaks_for("cpu") is None


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_predicted_launches_are_the_programs(monkeypatch, model):
    """One epoch and one refresh of the program on the CPU's kernel path
    call the two kernels exactly as often, with exactly the rows, that the
    yardstick predicts from the plan."""
    import tempfile

    from perfbench import harness
    from repro_torch.core.cache import HostCache
    from repro_torch.core.counters import Counters
    from repro_torch.core.engine import SSOEngine
    from repro_torch.core.storage import StorageTier
    from repro_torch.infer import OffloadedInference
    from repro_torch.kernels.gather_scatter import ops
    from repro_torch.models.gnn.layers import get_gnn
    from repro_torch.runtime import PipelineConfig

    seen = {"gather_rows": [0, 0.0], "scatter_add": [0, 0.0]}
    g_rows, s_add = ops.gather_rows, ops.scatter_add_

    def gather_rows(table, rows):
        out = g_rows(table, rows)
        rec = seen["gather_rows"]
        distinct = int(torch.unique(rows).numel())
        rec[0] += 1
        rec[1] += 4.0 * (distinct * table.shape[1] + rows.numel()
                         + out.numel())
        return out

    def scatter_add_(base, rows, values):
        rec = seen["scatter_add"]
        rec[0] += 1
        rec[1] += 3.0 * 4 * values.numel() + 4.0 * rows.numel()
        return s_add(base, rows, values)

    monkeypatch.setattr(ops, "gather_rows", gather_rows)
    monkeypatch.setattr(ops, "scatter_add_", scatter_add_)
    cfg = {"model": model, "dims": [16, 12, 12, 5], "heads": 4,
           "n_nodes": 600, "avg_degree": 6, "n_parts": 4,
           "edge_weight": "gcn_norm" if model == "gcn" else None}
    traffic = {"graph": {"structure_seed": 0, "partition_seed": 0, "a": 0.57, "b": 0.19, "c": 0.19}}
    dev = torch.device("cpu")
    inp = harness.make_inputs(cfg, traffic, 3, dev)
    plan, _ = harness.program_graph(cfg, traffic, inp, dev, {})
    params = harness.program_params(cfg, inp, dev)
    spec = get_gnn(model)
    pipe = PipelineConfig(depth=2, kernels="kernel")
    c = Counters()
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    eng = SSOEngine(spec, plan, cfg["dims"], st, HostCache(1 << 14, st, c),
                    c, pipeline=pipe, device=dev)
    try:
        eng.initialize(inp.x[plan.ro.perm])
        eng.run_epoch(params, inp.y[plan.ro.perm])
    finally:
        eng.close()
        st.close()
    want = yardstick.kernel_launches(plan, cfg["dims"], "train")
    for k in want:
        assert tuple(seen[k]) == pytest.approx(want[k], rel=1e-12), k
        seen[k] = [0, 0.0]
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    inf = OffloadedInference(spec, plan, cfg["dims"], st,
                             HostCache(1 << 14, st, c), c, pipeline=pipe,
                             device=dev)
    try:
        inf.initialize(inp.x[plan.ro.perm])
        inf.run(params)
    finally:
        inf.close()
        st.close()
    want = yardstick.kernel_launches(plan, cfg["dims"], "refresh")
    assert tuple(seen["gather_rows"]) == pytest.approx(want["gather_rows"])
    assert seen["scatter_add"][0] == 0
