"""Import isolation of the PyTorch port (``src/repro_torch/``).

The port must run where JAX does not exist: no module of it imports
``jax`` or anything of the reference package ``repro`` (not even its
numpy-only modules), and its entry points never drop to the CPU on their
own — with no device given and no CUDA device present they raise.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(SRC).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "repro" \
        or name.startswith("repro.")


def test_fresh_process_import_pulls_no_jax_and_no_reference_package():
    mods = _port_modules()
    assert "repro_torch.launch.infer" in mods and len(mods) > 20
    assert {"repro_torch.launch.train", "repro_torch.core.engine",
            "repro_torch.core.faults", "repro_torch.optim.adamw",
            "repro_torch.train.checkpoint", "repro_torch.train.loop"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=str(ROOT), timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"
], ids=lambda p: str(p.relative_to(ROOT)))
def test_ast_has_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def _tiny_plan(device):
    from repro_torch.core.plan import build_plan
    from repro_torch.graph import kronecker_graph, switching_aware_partition
    from repro_torch.graph.csr import add_self_loops, gcn_norm_coeffs

    g = add_self_loops(kronecker_graph(200, 5, seed=0))
    res = switching_aware_partition(g, 3, max_iters=4, seed=0)
    return build_plan(g, res.parts, 3, edge_weight=gcn_norm_coeffs(g),
                      device=device)


def test_entry_points_without_device_raise_when_cuda_is_absent(
    monkeypatch, tmp_path,
):
    from repro_torch.core.cache import HostCache
    from repro_torch.core.counters import Counters
    from repro_torch.core.engine import SSOEngine
    from repro_torch.core.storage import StorageTier
    from repro_torch.device import resolve_device
    from repro_torch.infer import OffloadedInference
    from repro_torch.launch.infer import _infer_smoke
    from repro_torch.launch.train import _train_smoke
    from repro_torch.models.gnn.layers import get_gnn

    plan = _tiny_plan("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    c = Counters()
    st = StorageTier(str(tmp_path), counters=c)
    with pytest.raises(RuntimeError, match="CUDA"):
        OffloadedInference(get_gnn("gcn"), plan, [8, 8, 4], st,
                           HostCache(1 << 20, st, c), c)
    with pytest.raises(RuntimeError, match="CUDA"):
        _tiny_plan(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        _infer_smoke("gcn", 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        SSOEngine(get_gnn("gcn"), plan, [8, 8, 4], st,
                  HostCache(1 << 20, st, c), c)
    with pytest.raises(RuntimeError, match="CUDA"):
        _train_smoke("gcn", 0)
    # the CPU, asked for, is fine
    assert resolve_device("cpu") == torch.device("cpu")
    inf = OffloadedInference(get_gnn("gcn"), plan, [8, 8, 4], st,
                             HostCache(1 << 20, st, c), c, device="cpu")
    inf.close()
    eng = SSOEngine(get_gnn("gcn"), plan, [8, 8, 4], st,
                    HostCache(1 << 20, st, c), c, device="cpu")
    eng.close()
    st.close()


def test_engine_refuses_a_plan_on_another_device(tmp_path):
    from repro_torch.core.cache import HostCache
    from repro_torch.core.counters import Counters
    from repro_torch.core.engine import SSOEngine
    from repro_torch.core.storage import StorageTier
    from repro_torch.infer import OffloadedInference
    from repro_torch.models.gnn.layers import get_gnn

    plan = _tiny_plan("cpu")
    plan.device = torch.device("meta")
    c = Counters()
    st = StorageTier(str(tmp_path), counters=c)
    for engine in (OffloadedInference, SSOEngine):
        with pytest.raises(ValueError, match="plan topologies"):
            engine(get_gnn("gcn"), plan, [8, 8, 4], st,
                   HostCache(1 << 20, st, c), c, device="cpu")
    st.close()


def test_launcher_rejects_non_gnn_and_unported_archs(capsys):
    from repro_torch.launch.infer import GNN_ARCHS, main
    from repro_torch.models.gnn.layers import GNN_REGISTRY

    for arch in ("mixtral-8x7b", "no-such-arch"):
        with pytest.raises(SystemExit) as ei:
            main(["--arch", arch])
        assert ei.value.code == 2
    out = capsys.readouterr().out
    assert "requires a GNN arch" in out
    # every family an arch id names is ported: none is refused as unported
    assert set(GNN_ARCHS.values()) <= set(GNN_REGISTRY)


def test_train_launcher_rejects_non_gnn_and_unported_archs(capsys):
    from repro_torch.launch.infer import GNN_ARCHS
    from repro_torch.launch.train import main
    from repro_torch.models.gnn.layers import GNN_REGISTRY

    for arch in ("mixtral-8x7b", "no-such-arch"):
        with pytest.raises(SystemExit) as ei:
            main(["--arch", arch, "--offload"])
        assert ei.value.code == 2
    out = capsys.readouterr().out
    assert "requires a GNN arch" in out
    # every family an arch id names is ported: none is refused as unported
    assert set(GNN_ARCHS.values()) <= set(GNN_REGISTRY)
