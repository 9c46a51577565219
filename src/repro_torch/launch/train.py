"""Training launcher: ``python -m repro_torch.launch.train --arch <id> --offload``.

The port's counterpart of ``python -m repro.launch.train --offload``: runs
the storage-offloaded SSO training engine (repro_torch/core/engine.py) for a
GNN arch on a small synthetic graph on the CUDA card — a serial and a
pipelined run, each of ``epochs`` epochs (forward, loss, backward) followed
by an AdamW update — and checks that the losses and gradients are finite
and that the pipelined run equals the serial one bitwise.

``--arch two-tower-retrieval --smoke`` is the reference launcher's
``arch.smoke()`` route for the recsys arch: one loss and gradient at the
``SMOKE`` widths on the card (:func:`_recsys_smoke`), printed as ``loss``,
``grad_norm`` and ``finite``, with the kernel path held against the
reference path bitwise.

Exit status 0 iff every check passes; 2 for an arch that is neither a GNN
arch nor ``two-tower-retrieval``, for a GNN arch without ``--offload``, and
for ``two-tower-retrieval`` without ``--smoke`` (the reference's dry-run
path is not ported). The reference launcher's ``--telemetry-port`` and
``--ledger`` options are not carried over yet (the live exporter and the
run ledger are not ported).
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


# recsys arch ids (``--smoke`` only)
RECSYS_ARCHS = ("two-tower-retrieval",)
RECSYS_SMOKE_BATCH = 8


def _recsys_smoke(device=None) -> dict:
    """The reference's ``make_recsys_arch(...).smoke()`` for
    ``two-tower-retrieval`` on ``device`` (the CUDA card unless
    ``device="cpu"``): the ``SMOKE`` model from ``torch.Generator`` seed 0,
    8 users and items of random ids (numpy seeds 1 and 2), and one in-batch
    softmax loss with its gradients, through the kernel path
    (``kernels="auto"``) and the reference path.

    Returns ``loss``, ``acc``, ``grad_norm`` (the sum of every gradient's
    absolute values, as the reference prints it), ``finite`` (loss and
    every gradient), ``kernel_matches_reference`` (loss and every gradient
    bitwise) and ``launches`` (each kernel's launches in the kernel path's
    call: two ``embedding_bag`` and two ``scatter_add`` on the card, none on
    the CPU, checked in ``launches_ok``)."""
    import numpy as np
    import torch

    from repro_torch.configs.two_tower_retrieval import SMOKE as cfg
    from repro_torch.device import resolve_device
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models.recsys.two_tower import (
        init_two_tower, two_tower_value_and_grad,
    )

    device = resolve_device(device)
    model = init_two_tower(cfg, torch.Generator(device).manual_seed(0),
                           device)

    def ids(seed, n_fields, vocab):
        a = np.random.default_rng(seed).integers(
            0, vocab, (RECSYS_SMOKE_BATCH, n_fields, cfg.bag_size))
        return torch.from_numpy(a.astype(np.int32)).to(device)

    u = ids(1, cfg.n_user_fields, cfg.user_vocab)
    i = ids(2, cfg.n_item_fields, cfg.item_vocab)
    reset_launches()
    (loss, acc), grads = two_tower_value_and_grad(model, u, i, cfg, "auto")
    launches = {k: v for k, v in launch_counts().items() if v}
    (loss_r, _), grads_r = two_tower_value_and_grad(model, u, i, cfg,
                                                    "reference")
    want = ({"embedding_bag": 2, "scatter_add": 2}
            if device.type == "cuda" else {})
    return dict(
        loss=float(loss), acc=float(acc),
        grad_norm=float(sum(float(g.abs().sum()) for g in grads.values())),
        finite=bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads.values()),
        kernel_matches_reference=bool(torch.equal(loss, loss_r)) and all(
            torch.equal(grads[k], grads_r[k]) for k in grads),
        launches=launches, launches_ok=launches == want,
    )


# the dense oracle check (float64 oracle): loss and max-relative gradients
DENSE_LOSS_TOL = 1e-4
DENSE_GRAD_TOL = 5e-4


def dense_ok(r: dict) -> bool:
    """``_train_smoke``'s dense oracle check: the loss within
    ``DENSE_LOSS_TOL`` and the gradients within ``DENSE_GRAD_TOL`` of the
    float64 oracle, or, where float32 takes the other branch of some kinks,
    of the float64 oracle on those branches (see ``_train_smoke``)."""
    return r["dense_loss_rel_err"] <= DENSE_LOSS_TOL and (
        r["dense_grad_rel_err"] <= DENSE_GRAD_TOL
        or r.get("dense_grad_rel_err_f32_branches", 1.0) <= DENSE_GRAD_TOL)


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
    gradients are held against a dense whole-graph autograd oracle in
    float64 on ``device`` (off where the whole graph's messages do not fit
    on the device): ``dense_loss_rel_err`` / ``dense_grad_rel_err``, within
    ``DENSE_LOSS_TOL`` / ``DENSE_GRAD_TOL`` by :func:`dense_ok`. Where the
    gradients are not, the oracle counts ``kink_flips``: the ``relu`` /
    ``leaky_relu`` inputs whose sign a float32 forward of the oracle gets
    the other way (:class:`~repro_torch.models.gnn.layers.KinkProbe`). A
    kink's gradient jumps across 0, so one such element moves a whole
    weight's gradient (GAT at 20,000 nodes on the card: ~3e-3). With flips,
    ``dense_grad_rel_err_f32_branches`` is the error against the float64
    oracle run on the float32 branches, float64 everywhere else; it is held
    to the same tolerance. ``runs``
    maps each depth to its per-epoch losses, grads and wall seconds, its
    ``Counters`` and its peak device bytes."""
    import dataclasses
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
        full_graph_loss, full_graph_topo, get_gnn, kink_probe,
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
        # the oracle at the weights of the first epoch (fresh init)
        rg = plan.ro.graph
        got = [t for layer in serial["grads"][0] for t in layer.values()]

        def oracle(dt, force=None, grad=True):
            """(loss, gradients, kink signs) of the whole-graph oracle in
            ``dt``: weights, features and the topology's float fields."""
            params = init_params().to(dt)
            topo = full_graph_topo(rg.indptr, rg.indices, rg.n_nodes,
                                   plan.edge_weight, device=device)
            topo = dataclasses.replace(
                topo, edge_weight=topo.edge_weight.to(dt),
                edge_mask=topo.edge_mask.to(dt), in_deg=topo.in_deg.to(dt))
            x = X.astype(np.float64) if dt == torch.float64 else X
            with kink_probe(force) as probe, torch.set_grad_enabled(grad):
                loss = full_graph_loss(spec, params, x, topo, Y)
                if grad:
                    loss.backward()
            want = [p.grad for layer in params for p in layer.parameters()]
            return float(loss.detach()), want, probe.signs

        def grad_err(want):
            return max(_rel_err(w, gt) for w, gt in zip(want, got))

        loss, want, signs64 = oracle(torch.float64)
        out["dense_loss_rel_err"] = (
            abs(serial["losses"][0] - loss) / max(1.0, abs(loss)))
        out["dense_grad_rel_err"] = grad_err(want)
        del want
        if out["dense_grad_rel_err"] > DENSE_GRAD_TOL:
            _, _, signs32 = oracle(torch.float32, grad=False)
            out["kink_flips"] = sum(int((a != b).sum())
                                    for a, b in zip(signs32, signs64))
            if out["kink_flips"]:
                out["dense_grad_rel_err_f32_branches"] = grad_err(
                    oracle(torch.float64, force=signs32)[1])
            del signs32
        del signs64
    out["runs"] = runs
    return out


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="a GNN arch id (e.g. gcn-cora; the model family "
                         "is recovered from the config naming convention) "
                         "or two-tower-retrieval")
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
    ap.add_argument("--smoke", action="store_true",
                    help="one loss and gradient of a recsys arch at its "
                         "SMOKE widths on the card")
    args = ap.parse_args(argv)
    if args.trace:
        import logging
        logging.basicConfig(level=logging.INFO,
                            format="%(name)s %(message)s")

    if args.arch in RECSYS_ARCHS:
        if args.offload or not args.smoke:
            print(f"{args.arch}: only --smoke is ported for recsys archs "
                  f"(--offload needs a GNN arch)")
            sys.exit(2)
        r = _recsys_smoke()
        print(f"{args.arch} smoke: {r}")
        ok = r["finite"] and r["kernel_matches_reference"] and r["launches_ok"]
        sys.exit(0 if ok else 1)
    if args.arch not in GNN_ARCHS:
        print(f"{args.arch}: training requires a GNN arch "
              f"(one of {sorted(GNN_ARCHS)}) or one of {sorted(RECSYS_ARCHS)}")
        sys.exit(2)
    model = GNN_ARCHS[args.arch]
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
    ok = r["finite"] and r["pipeline_matches_serial"] and dense_ok(r)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
