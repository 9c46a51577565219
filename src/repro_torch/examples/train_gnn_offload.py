"""End-to-end run: offloaded full-graph GNN training beyond host-cache
capacity, with fault-tolerant checkpointing — the port of
``examples/train_gnn_offload.py``.

This is the paper's headline scenario: activations for all layers exceed the
host budget, so the engine runs cache-(re)gather-bypass against the storage
tier. Training runs a few hundred epochs with periodic checkpoints; kill and
re-run to watch it resume. Every tenth epoch prints the epoch time that the
tier cost model gives for the bytes moved so far at the rates of
``costmodel.H100_MACHINE``.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_gnn_offload [--epochs 200]

On the CUDA card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch.core.cache import HostCache
from repro_torch.core.costmodel import H100_MACHINE, modeled_time
from repro_torch.core.counters import Counters
from repro_torch.core.engine import SSOEngine
from repro_torch.core.plan import build_plan
from repro_torch.core.storage import StorageTier
from repro_torch.device import resolve_device
from repro_torch.graph import (
    gcn_norm_coeffs, kronecker_graph, switching_aware_partition,
)
from repro_torch.graph.csr import add_self_loops
from repro_torch.graph.synthetic import random_features, random_labels
from repro_torch.models.gnn.layers import get_gnn
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.runtime import PipelineConfig
from repro_torch.train.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint,
)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--nodes", type=int, default=30000)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--layers", type=int, default=5)
    ap.add_argument("--parts", type=int, default=16)
    ap.add_argument("--cache-mb", type=int, default=24)
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="async runtime lookahead (0 = serial engine)")
    ap.add_argument("--gather-workers", type=int, default=1,
                    help="parallel host-gather workers (joined in schedule "
                         "order; useful on multi-core boxes)")
    ap.add_argument("--device-slots", type=int, default=2,
                    help="device-side staging slots for the async H2D "
                         "transfer stage (2 = double buffer)")
    ap.add_argument("--no-transfer-stage", action="store_true",
                    help="disable the async H2D/D2H device-transfer stage")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="write a Chrome/Perfetto trace_event timeline "
                         "(exported when the engine closes; open in "
                         "ui.perfetto.dev)")
    ap.add_argument("--ckpt",
                    default=os.path.join(tempfile.gettempdir(),
                                         "grinnder_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="checkpoint after every this many epochs")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    g = add_self_loops(kronecker_graph(args.nodes, 10, seed=0))
    res = switching_aware_partition(g, args.parts, max_iters=30)
    plan = build_plan(g, res.parts, args.parts,
                      edge_weight=gcn_norm_coeffs(g), device=device)
    H = args.hidden
    dims = [H] + [H] * (args.layers - 1) + [16]
    D = g.n_nodes * H * 4
    total_act = D * (args.layers + 1)
    print(f"graph {g.n_nodes}x{g.n_edges} alpha={plan.alpha:.2f}; "
          f"activation state {total_act/1e6:.0f}MB vs host cache "
          f"{args.cache_mb}MB -> offloading engaged")

    X = random_features(g.n_nodes, H, 0)[plan.ro.perm]
    Y = random_labels(g.n_nodes, 16, 0)[plan.ro.perm]
    spec = get_gnn("gcn")
    params = spec.init(torch.Generator().manual_seed(0), H, H, 16,
                       args.layers, device=device)
    opt = adamw_init(params)

    c = Counters()
    storage = StorageTier(tempfile.mkdtemp(prefix="grinnder_e2e_"),
                          counters=c)
    cache = HostCache(args.cache_mb << 20, storage, c)
    engine = SSOEngine(spec, plan, dims, storage, cache, c,
                       mode="regather",
                       pipeline=PipelineConfig(
                           depth=args.pipeline_depth,
                           gather_workers=args.gather_workers,
                           transfer_stage=not args.no_transfer_stage,
                           device_slots=args.device_slots,
                           trace=args.trace),
                       device=device)
    start = 0
    losses, saved = [], []
    try:
        engine.initialize(X)
        path = latest_checkpoint(args.ckpt)
        if path:
            params, opt, start, _ = restore_checkpoint(path, params, opt)
            print(f"resumed from {path} at epoch {start}")

        for epoch in range(start, args.epochs):
            loss, grads = engine.run_epoch(params, Y)
            params, opt = adamw_update(grads, params, opt, lr=5e-3)
            losses.append(loss)
            if epoch % 10 == 0:
                mt = modeled_time(c, H100_MACHINE)
                print(f"epoch {epoch:4d} loss {loss:.5f} | storage "
                      f"{(c.storage_read_bytes+c.storage_write_bytes)/1e9:.2f}"
                      f"GB cumulative | modeled epoch "
                      f"{mt.overlapped/max(epoch-start+1,1)*1e3:.0f}ms")
            if (epoch + 1) % args.ckpt_every == 0:
                saved.append(save_checkpoint(args.ckpt, epoch + 1, params,
                                             opt))
                print(f"checkpointed at epoch {epoch + 1}")
        if args.pipeline_depth > 0:
            print("pipeline busy(s): "
                  + ", ".join(f"{k}={v:.2f}" for k, v in
                              sorted(c.stage_busy_seconds.items())))
            print("pipeline stall(s): "
                  + ", ".join(f"{k}={v:.2f}" for k, v in
                              sorted(c.stage_stall_seconds.items())))
    finally:
        engine.close()
        storage.close()
    if args.trace:
        print(f"trace written to {args.trace} (open in ui.perfetto.dev)")
    print("done")
    return dict(start=start, losses=losses, checkpoints=saved, params=params,
                counters=c)


if __name__ == "__main__":
    # per-epoch summaries (stall top-3, cache hit rate, read amplification)
    # log on the repro_torch.obs logger — surface them on the console
    logging.basicConfig(level=logging.INFO, format="%(name)s %(message)s")
    main()
