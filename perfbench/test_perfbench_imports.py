"""Nothing the benchmark runs is JAX or the JAX package: by AST over every
file under ``perfbench/``, and by the module table of a CPU pass through
the harness's whole import graph. The reference imports nothing of the
program."""
import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from perfbench import harness

FILES = sorted(harness.BENCH_DIR.rglob("*.py"))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(harness.BENCH_DIR)))
def test_no_jax_by_ast(path):
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)
    if "reference" in path.parts:
        assert "repro_torch" not in tops


def test_forbidden_names_are_whole_top_level_names():
    mods = dict(sys.modules)
    try:
        sys.modules["repro_torch_like"] = sys
        sys.modules["reprox.y"] = sys
        assert "repro" not in harness.forbidden_modules()
        sys.modules["repro.core"] = sys
        assert "repro" in harness.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(mods)


def test_cpu_pass_loads_no_jax():
    """A run of every cell at a tiny size on the CPU, in a fresh process,
    then its module table."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(harness.REPO)!r}, {str(harness.REPO / 'src')!r}]
        import torch
        from perfbench import harness
        for name in {[w['name'] for w in harness.load_json(harness.REPO / 'BENCHMARK.json')['workloads']]!r}:
            cell = harness.load_cell(name)
            cell.config.update(n_nodes=600, dims=[16, 8, 8, 5], n_parts=4)
            out = harness.run(cell, 11, 0.01, False, torch.device('cpu'),
                              time.perf_counter())
            assert out['correct'], out
        tops = sorted({{m.split('.', 1)[0] for m in sys.modules}})
        print(' '.join(tops))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    tops = set(res.stdout.split())
    assert "repro_torch" in tops and "perfbench" in tops
    assert not tops & set(harness.FORBIDDEN)
