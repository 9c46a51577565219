"""The comparison's control on the card: the plain reference in float32
with TF32 matmuls, put in the program's place, comes out not correct at
the published widths (a smaller graph than the cells'); the program
itself comes out correct on the same inputs. Run on the card with
``python -m pytest -m cuda perfbench/test_perfbench_control.py``."""
import pytest
import torch

from perfbench import compare, harness

CELLS = [w["name"] for w in harness.load_json(
    harness.REPO / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    import importlib

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.load_cell(name)
    cell.config.update(n_nodes=16384, n_parts=8)
    entry = importlib.import_module(
        f"perfbench.entries.{cell.traffic['entry']}").Entry(
        cell.config, cell.traffic, 123456789012, dev)
    entry.setup()
    entry.close()
    ref = entry.reference()
    ctl = entry.reference(dtype=torch.float32, tf32=True)
    if cell.traffic["entry"] == "train":
        prog = compare.train_numbers(entry.readings(), ref)
        ctl = compare.train_numbers(ctl, ref)
    else:
        prog = entry.check(ref)
        ctl = compare.table_numbers(ctl, ref)
    assert compare.judge(prog, cell.limits)[0], prog
    assert not compare.judge(ctl, cell.limits)[0], ctl
