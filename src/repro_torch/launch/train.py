"""Training launcher: ``python -m repro_torch.launch.train --arch <id> --offload``.

The port's counterpart of ``python -m repro.launch.train --offload``: runs
the storage-offloaded SSO training engine (repro_torch/core/engine.py) for a
GNN arch on a small synthetic graph on the CUDA card — a serial and a
pipelined run, each of ``epochs`` epochs (forward, loss, backward) followed
by an AdamW update — and checks that the losses and gradients are finite
and that the pipelined run equals the serial one bitwise.

Exit status 0 iff every check passes; 2 for a non-GNN or unported arch, or
without ``--offload`` (the reference's ``--smoke`` / dry-run paths run
non-GNN models, which are not ported). The reference launcher's
``--telemetry-port`` and ``--ledger`` options are not carried over yet (the
live exporter and the run ledger are not ported).
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.launch.infer import GNN_ARCHS, _smoke_graph


def _rel_err(a, b) -> float:
    """max |a - b| / max |a| over two tensors (float64 on the host)."""
    import numpy as np

    a = a.detach().double().cpu().numpy()
    b = b.detach().double().cpu().numpy()
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-12))


def _train_smoke(
    model: str,
    depth: int,
    gather_workers: int = 1,
    transfer_stage: bool = True,
    device_slots: int = 2,
    trace: Optional[str] = None,
    dims: Optional[Sequence[int]] = None,
    n_nodes: int = 2000,
    n_parts: int = 6,
    avg_degree: int = 7,
    cache_mb: int = 4,
    kernels: str = "auto",
    epochs: int = 1,
    dense_check: bool = True,
    mode: str = "regather",
    device=None,
) -> dict:
    """Drive SSOEngine (serial + pipelined) for a GNN arch on ``device``
    (the CUDA card unless ``device="cpu"``); returns the check/stat dict.
    ``dims`` defaults to ``[24, 32, 8]`` (input, hidden..., output).

    Each run initialises fresh weights (``torch.Generator`` seed 0) and
    AdamW state, then runs ``epochs`` epochs, each one ``run_epoch`` and one
    ``adamw_update``. With ``dense_check`` the first epoch's loss and
    gradients are held against a dense whole-graph autograd oracle (off
    where the whole graph's messages do not fit on the device). ``runs``
    maps each depth to its per-epoch losses, grads and wall seconds, its
    ``Counters`` and its peak device bytes."""
    import tempfile
    import time

    import numpy as np
    import torch

    from repro_torch.core.cache import HostCache
    from repro_torch.core.counters import Counters
    from repro_torch.core.engine import SSOEngine
    from repro_torch.core.storage import StorageTier
    from repro_torch.device import resolve_device
    from repro_torch.graph.synthetic import random_features, random_labels
    from repro_torch.models.gnn.layers import (
        full_graph_loss, full_graph_topo, get_gnn,
    )
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.runtime import PipelineConfig

    device = resolve_device(device)
    on_card = device.type == "cuda"
    dims = list(dims) if dims is not None else [24, 32, 8]
    g, plan = _smoke_graph(n_nodes, avg_degree, n_parts, device)
    spec = get_gnn(model)
    X = random_features(g.n_nodes, dims[0], 0)[plan.ro.perm]
    Y = random_labels(g.n_nodes, dims[-1], 0)[plan.ro.perm]
    # the kernel modes stage whole partition blocks: one stack can hold
    # every block of the widest layer, so let the pool park a few of those
    stack_bytes = (g.n_nodes + 1) * max(dims) * 4

    def init_params():
        return spec.init(torch.Generator().manual_seed(0), dims[0], dims[1],
                         dims[-1], len(dims) - 1, device=device)

    runs = {}
    for d in sorted({0, depth}):
        c = Counters()
        st_ = StorageTier(tempfile.mkdtemp(), counters=c)
        cache = HostCache(cache_mb << 20, st_, c)
        eng = SSOEngine(
            spec, plan, dims, st_, cache, c, mode=mode,
            pipeline=PipelineConfig(
                depth=d, gather_workers=gather_workers,
                transfer_stage=transfer_stage, device_slots=device_slots,
                kernels=kernels,
                pool_max_bytes=max(PipelineConfig.pool_max_bytes,
                                   4 * stack_bytes),
                # trace the requested depth only (the other iteration is
                # the serial equivalence check)
                trace=trace if d == depth else None,
            ),
            device=device,
        )
        params = init_params()
        opt = adamw_init(params)
        losses, grads, walls = [], [], []
        try:
            eng.initialize(X)
            if on_card:
                torch.cuda.reset_peak_memory_stats(device)
            for _ in range(epochs):
                t0 = time.perf_counter()
                loss, gr = eng.run_epoch(params, Y)
                params, opt = adamw_update(gr, params, opt, lr=1e-2)
                if on_card:
                    torch.cuda.synchronize(device)
                walls.append(time.perf_counter() - t0)
                losses.append(loss)
                grads.append(gr)
        finally:
            eng.close()
            st_.close()
        runs[d] = dict(
            losses=losses, grads=grads, counters=c, wall_s=walls,
            peak_device_bytes=(torch.cuda.max_memory_allocated(device)
                               if on_card else 0),
        )

    serial, piped = runs[0], runs[depth]

    def flat(r):   # every epoch's every gradient, in order
        return [t for gr in r["grads"] for layer in gr for t in layer.values()]

    out = dict(
        finite=all(
            bool(np.all(np.isfinite(r["losses"])))
            and all(bool(torch.isfinite(t).all()) for t in flat(r))
            for r in runs.values()
        ),
        loss=piped["losses"][-1],
        serial_loss=serial["losses"][-1],
        pipeline_matches_serial=(
            serial["losses"] == piped["losses"]
            and all(torch.equal(a, b)
                    for a, b in zip(flat(serial), flat(piped)))
        ),
        depth=depth,
        kernels=kernels,
        mode=mode,
        epochs=epochs,
        wall_s=piped["wall_s"][-1],
    )
    if dense_check:
        # the oracle at the weights of the first epoch: fresh init
        params = init_params()
        rg = plan.ro.graph
        topo = full_graph_topo(rg.indptr, rg.indices, rg.n_nodes,
                               plan.edge_weight, device=device)
        loss = full_graph_loss(spec, params, X, topo, Y)
        loss.backward()
        loss = float(loss.detach())
        want = [p.grad for layer in params for p in layer.parameters()]
        del topo
        got = [t for layer in serial["grads"][0] for t in layer.values()]
        out["dense_grad_rel_err"] = max(
            _rel_err(w, gt) for w, gt in zip(want, got))
        out["dense_loss_rel_err"] = abs(
            serial["losses"][0] - loss) / max(1.0, abs(loss))
    out["runs"] = runs
    return out


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="a GNN arch id (e.g. gcn-cora); the model family "
                         "is recovered from the config naming convention")
    ap.add_argument("--offload", action="store_true",
                    help="run the storage-offloading engine smoke (GNN "
                         "archs; uses the SSO pipeline runtime)")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="async pipeline lookahead for --offload "
                         "(0 = serial engine)")
    ap.add_argument("--gather-workers", type=int, default=1,
                    help="parallel host-gather workers for --offload")
    ap.add_argument("--device-slots", type=int, default=2,
                    help="device staging slots for the transfer stage")
    ap.add_argument("--no-transfer-stage", action="store_true",
                    help="disable the async H2D/D2H device-transfer stage")
    ap.add_argument("--trace", metavar="OUT.json", default=None,
                    help="write a Chrome/Perfetto trace_event timeline of "
                         "the --offload run (open in ui.perfetto.dev)")
    args = ap.parse_args(argv)
    if args.trace:
        import logging
        logging.basicConfig(level=logging.INFO,
                            format="%(name)s %(message)s")

    from repro_torch.models.gnn.layers import GNN_REGISTRY

    if args.arch not in GNN_ARCHS:
        print(f"{args.arch}: training requires a GNN arch "
              f"(one of {sorted(GNN_ARCHS)})")
        sys.exit(2)
    model = GNN_ARCHS[args.arch]
    if model not in GNN_REGISTRY:
        print(f"{args.arch}: model {model!r} is not ported yet "
              f"(ported: {sorted(GNN_REGISTRY)})")
        sys.exit(2)
    if not args.offload:
        print(f"{args.arch}: only --offload (the SSO engine) is ported")
        sys.exit(2)
    r = _train_smoke(
        model, args.pipeline_depth, args.gather_workers,
        transfer_stage=not args.no_transfer_stage,
        device_slots=args.device_slots, trace=args.trace,
    )
    r.pop("runs")
    print(f"{args.arch} offload smoke: {r}")
    if args.trace:
        print(f"trace written to {args.trace}")
    ok = (
        r["finite"]
        and r["pipeline_matches_serial"]
        and r.get("dense_loss_rel_err", 0.0) <= 1e-4
        and r.get("dense_grad_rel_err", 0.0) <= 5e-4
    )
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
