"""Every cell, configuration, traffic mix, limit file and per-layer metric
of ``BENCHMARK.json`` is found by name, and the file keeps the contract's
shape."""
import json
import re

import pytest

from perfbench import harness

BENCH = json.loads((harness.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("name", CELLS)
def test_cell_found_by_name(name):
    cell = harness.load_cell(name, BENCH)
    entry = cell.traffic["entry"]
    assert (harness.BENCH_DIR / "entries" / f"{entry}.py").is_file()
    assert (harness.BENCH_DIR / "reference" /
            f"{cell.config['model']}.py").is_file()
    assert set(cell.limits) == ({"emb_gap"} if entry == "refresh" else
                                {"loss1_gap", "grad_gap", "grad_med_gap", "step_gap"})
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer and all(m["moves"] in e2e for m in cell.per_layer)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_holds_its_cut(cfg):
    path = harness.REPO / cfg["file"]
    assert path.parts[len(harness.REPO.parts)] == "perfbench"
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert data[key] != data["published"][key]
    assert data["dims"][0] == data["published"]["d_feat"]
    assert data["dims"][-1] == data["published"]["n_classes"]
    assert set(data["dims"][1:-1]) == {data["published"]["d_hidden"]}
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_found_by_name(metric):
    assert callable(harness.metric_reader(metric["name"]))
    assert set(metric["workloads"]) <= set(CELLS)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
