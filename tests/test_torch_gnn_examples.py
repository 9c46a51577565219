"""The port's three GNN examples (``repro_torch.examples``) at tiny sizes on
the CPU.

- ``quickstart``: every epoch's offloaded loss within 1e-4 of in-memory
  autograd on the whole graph (SGD steps on both);
- ``train_gnn_offload``: a run with a checkpoint, then a run that resumes
  from it, equal bitwise (losses and final parameters) to one straight run;
  its modeled epoch comes from the ``H100_MACHINE`` profile;
- ``serve_gnn_embeddings --smoke``: exit 0 (served rows equal a dense
  forward, cache hits under zipf traffic).
"""
import math

import torch

from repro_torch.examples import (
    quickstart, serve_gnn_embeddings, train_gnn_offload,
)

TINY = ["--nodes", "1200", "--parts", "4", "--device", "cpu"]


def test_quickstart_loss_curve_equals_in_memory_autograd(capsys):
    r = quickstart.main(TINY + ["--epochs", "3"])
    assert len(r["losses"]) == len(r["ref_losses"]) == 3
    for a, b in zip(r["losses"], r["ref_losses"]):
        assert abs(a - b) < quickstart.MATCH_TOL
    assert r["match"]
    assert r["losses"][-1] < r["losses"][0]
    assert "match: True" in capsys.readouterr().out


def test_train_gnn_offload_resume_equals_straight_run(tmp_path, capsys):
    argv = TINY + ["--layers", "3", "--hidden", "16", "--cache-mb", "1"]
    straight = train_gnn_offload.main(
        argv + ["--epochs", "3", "--ckpt", str(tmp_path / "a")])
    first = train_gnn_offload.main(
        argv + ["--epochs", "2", "--ckpt-every", "2",
                "--ckpt", str(tmp_path / "b")])
    resumed = train_gnn_offload.main(
        argv + ["--epochs", "3", "--ckpt-every", "2",
                "--ckpt", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert straight["start"] == 0 and straight["checkpoints"] == []
    assert len(first["checkpoints"]) == 1
    assert resumed["start"] == 2 and "resumed from" in out
    assert "modeled epoch" in out
    assert all(math.isfinite(x) for x in straight["losses"])
    assert first["losses"] + resumed["losses"] == straight["losses"]
    for a, b in zip(straight["params"].parameters(),
                    resumed["params"].parameters()):
        assert torch.equal(a, b)


def test_serve_gnn_embeddings_smoke_on_cpu(capsys):
    assert serve_gnn_embeddings.main(["--smoke", "--device", "cpu"]) == 0
    assert "smoke verification vs dense forward: OK" in \
        capsys.readouterr().out
