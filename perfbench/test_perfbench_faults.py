"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; the same run unbroken comes out correct.
The harness's look for a card is skipped: the run is driven on the CPU at
the published widths on a small graph. Also the command line's refusals."""
import contextlib
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from perfbench import faults, harness

CELLS = [w["name"] for w in harness.load_json(
    harness.REPO / "BENCHMARK.json")["workloads"]]
TRAIN = [c for c in CELLS if harness.load_cell(c).traffic["entry"] == "train"]
# cells whose answers are checked one by one (a table of embeddings)
ANSWERS = [c for c in CELLS if c not in TRAIN]


def _run(name, fault=None, seed=2**31 + 77):
    cell = harness.load_cell(name)
    cell.config.update(n_nodes=2048, n_parts=4)
    cm = contextlib.nullcontext() if fault is None else fault(cell)
    with cm:
        return harness.run(cell, seed, 0.01, False, torch.device("cpu"),
                           time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_unbroken_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_state_unchanged_is_caught(name):
    out = _run(name, lambda cell: faults.state_unchanged())
    assert not out["correct"]
    assert out["checks"]["step_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", TRAIN)
def test_half_batch_is_caught(name):
    out = _run(name, lambda cell: faults.half_batch())
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", ANSWERS)
def test_altered_answer_is_caught(name):
    out = _run(name, lambda cell: faults.answer_altered(cell.config["model"]))
    assert not out["correct"], out["checks"]


def test_no_card_no_result():
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and res.stdout == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode != 0 and res.stdout == ""
