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

``--arch phi3-medium-14b --shape prefill_32k|decode_32k`` is the
counterpart of the reference launcher's full-config branch (which hands an
LM cell to the dry run): it runs that cell's serving step on the card at
``CONFIG`` widths, weights from ``torch.Generator`` seed 0 and tokens from
numpy seed 0 (:func:`_lm_prefill`, :func:`_lm_decode`). ``--batch``,
``--seq`` and ``--layers`` cut the cell, ``--kernels`` routes the prefill's
attention; ``--smoke`` runs at the ``SMOKE`` widths (batch 2, 64 tokens by
default) and takes ``--device cpu``. It prints wall, tokens/s, achieved
TFLOP/s (``lm_model_flops`` plus ``lm_attention_correction``) and peak
device GB. ``train_4k``, and ``--smoke`` without a serving shape (the
reference's ``--smoke`` is a loss and its gradients), exit 2: LM training
comes with its slice. ``long_500k`` is skipped for a full-attention arch,
with the reference's reason.

Exit status 0 iff every check passes (or the cell is skipped); 2 for an
arch that is neither a GNN arch, ``two-tower-retrieval`` nor an LM arch,
for a GNN arch without ``--offload``, for ``two-tower-retrieval`` without
``--smoke`` (the reference's dry-run path is not ported) and for LM
training.

With ``--offload``, ``--telemetry-port PORT`` serves live Prometheus
metrics (``GET /metrics``, :class:`~repro_torch.obs.live.TelemetryServer`;
0 picks a free port) over the requested depth's run, and ``--ledger
[PATH]`` appends one ``train_offload_smoke`` record
(:mod:`repro_torch.obs.ledger`, ``backend`` the device type) to that JSONL
ledger. ``--device cpu`` runs the smoke on the CPU.
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


# LM arch ids -> their configuration module (``CONFIG``, ``SMOKE``)
LM_ARCHS = {"phi3-medium-14b": "repro_torch.configs.phi3_medium_14b"}
LM_TRAINING = "LM training comes with its slice of the port"
# the prefill's warm-up length and the decode steps after the filled cache
LM_WARMUP_SEQ = 1024
LM_DECODE_STEPS = 32
# --smoke's default cut of a serving cell
LM_SMOKE_BATCH = 2
LM_SMOKE_SEQ = 64


def lm_cell_skip(cfg, shape: str) -> Optional[str]:
    """Why a cell does not run for ``cfg`` (the reference's
    ``make_lm_arch`` rule), or None."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention arch: long_500k requires sub-quadratic "
                "attention (DESIGN.md §4)")
    return None


def _peak_gb(dev) -> float:
    import torch

    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else 0.0)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _profiled(fn, dev, top: int = 12) -> str:
    """One call of ``fn`` under ``torch.profiler`` (CPU and, on the card,
    CUDA activities): the wall of the window, the device's busy share in
    it (the kernels' summed device time over the wall) and the ``top``
    operators by self device time (self CPU time on the CPU)."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import torch

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):    # the tracer's start-up, outside
        torch.ones(1, device=dev).add_(1)
        _sync(dev)
    _sync(dev)
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        _sync(dev)
    wall = time.perf_counter() - t0
    ka = prof.key_averages()
    if dev.type != "cuda":
        return (f"profile: wall {wall * 1e3:.3f} ms\n"
                + ka.table(sort_by="self_cpu_time_total", row_limit=top))
    busy = sum(e.self_device_time_total for e in ka
               if e.device_type == DeviceType.CUDA) / 1e6
    return (f"profile: wall {wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f}"
            f" ms ({busy / wall:.1%})\n"
            + ka.table(sort_by="self_device_time_total", row_limit=top))


def _lm_prefill(model, batch: int, seq: int, kernels: str = "kernel",
                warmup_seq: int = LM_WARMUP_SEQ, seed: int = 0,
                profile: bool = False) -> dict:
    """One timed ``make_prefill_step`` call on ``model``'s device: tokens
    ``(batch, seq)`` uniform from numpy ``seed``, after a warm-up call on
    their first ``warmup_seq`` tokens (0: none). Returns the wall (host
    clock, ending in a synchronise), tokens/s, achieved TFLOP/s
    (``lm_model_flops`` + ``lm_attention_correction``), peak device GB of
    the timed call, its ``flash_attention`` launches, ``finite`` and the
    last-position ``logits``; with ``profile``, one more call under
    :func:`_profiled` (``profile``)."""
    import time

    import numpy as np
    import torch

    from repro_torch.configs.base import (
        lm_attention_correction, lm_model_flops,
    )
    from repro_torch.kernels import launch_counts
    from repro_torch.models.lm.steps import make_prefill_step

    cfg, dev = model.cfg, model.device
    step = make_prefill_step(cfg, kernels, dev)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, seq)).astype(np.int32)).to(dev)
    if warmup_seq:
        step(model, toks[:, :warmup_seq])
    _reset_peak(dev)
    before = launch_counts()["flash_attention"]
    t0 = time.perf_counter()
    logits = step(model, toks)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = launch_counts()["flash_attention"] - before
    flops = (lm_model_flops(cfg, "prefill", batch, seq)
             + lm_attention_correction(cfg, "prefill", batch, seq)["flops"])
    out = dict(
        batch=batch, seq=seq, kernels=kernels, wall_s=wall,
        tokens_per_s=batch * seq / wall, tflops=flops / wall / 1e12,
        peak_gb=_peak_gb(dev), launches=launches,
        finite=bool(torch.isfinite(logits).all()), logits=logits,
    )
    if profile:
        out["profile"] = _profiled(lambda: step(model, toks), dev)
    return out


def _lm_decode(model, batch: int, seq: int, steps: int = LM_DECODE_STEPS,
               kernels: str = "kernel", seed: int = 0,
               profile: bool = False) -> dict:
    """``steps`` greedy ``make_decode_step`` calls on ``model``'s device
    against a ``seq``-position KV cache whose first ``seq - steps``
    positions hold normals from a ``torch.Generator`` seeded with ``seed``
    (a stand-in for a prefilled prompt), so the steps fill the last
    positions. The first token is uniform from numpy ``seed``, each next
    one the argmax of the step's logits. Returns per-step walls (host
    clock around the step and its argmax, ending in a synchronise), p50 /
    p99 ms, tokens/s at p50, TFLOP/s at p50 (``lm_model_flops``), peak
    device GB over the steps (cache included), ``finite``, the tokens;
    with ``profile``, the last step once more (the same position) under
    :func:`_profiled` (``profile``)."""
    import time

    import numpy as np
    import torch

    from repro_torch.configs.base import lm_model_flops
    from repro_torch.models.lm.steps import make_decode_step
    from repro_torch.models.lm.transformer import init_kv_cache

    cfg, dev = model.cfg, model.device
    if not 1 <= steps <= seq:
        raise ValueError(f"steps={steps} outside [1, seq={seq}]")
    fill = seq - steps
    _reset_peak(dev)
    cache = init_kv_cache(cfg, batch, seq, device=dev)
    gen = torch.Generator(dev).manual_seed(seed)
    for name in ("k", "v"):
        for i in range(cfg.n_layers):
            cache[name][i, :, :fill].copy_(torch.randn(
                (batch, fill, cfg.n_kv_heads, cfg.d_head), generator=gen,
                device=dev))
    step = make_decode_step(cfg, kernels, dev)
    tok = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, 1)).astype(np.int32)).to(dev)
    walls, tokens, finite = [], [], True
    _sync(dev)
    for t in range(steps):
        t0 = time.perf_counter()
        logits, cache = step(model, cache, tok, fill + t + 1)
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        _sync(dev)
        walls.append(time.perf_counter() - t0)
        finite &= bool(torch.isfinite(logits).all())
        tokens.append(tok[:, 0].tolist())
    p50 = float(np.percentile(walls, 50))
    out = dict(
        batch=batch, seq=seq, steps=steps, walls_s=walls,
        p50_ms=p50 * 1e3, p99_ms=float(np.percentile(walls, 99)) * 1e3,
        tokens_per_s=batch / p50,
        tflops=lm_model_flops(cfg, "decode", batch, seq) / p50 / 1e12,
        peak_gb=_peak_gb(dev), finite=finite, tokens=tokens,
    )
    if profile:
        out["profile"] = _profiled(lambda: step(model, cache, tok, seq), dev)
    return out


def _lm_main(args) -> int:
    """The LM branch of :func:`main`; returns the exit status."""
    import dataclasses
    import importlib

    import torch

    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.device import resolve_device
    from repro_torch.models.lm.transformer import init_lm_params

    if args.offload:
        print(f"{args.arch}: --offload requires a GNN arch")
        return 2
    if args.shape is None:
        what = ("--smoke without --shape is the reference's loss and "
                "gradients" if args.smoke else "no --shape given")
        print(f"{args.arch}: {what}; {LM_TRAINING} (serving: --shape "
              f"prefill_32k or decode_32k)")
        return 2
    if args.shape not in LM_SHAPES:
        print(f"{args.arch}: unknown shape {args.shape!r} "
              f"(one of {sorted(LM_SHAPES)})")
        return 2
    cell = LM_SHAPES[args.shape]
    if cell["kind"] == "train":
        print(f"{args.arch} {args.shape}: {LM_TRAINING}")
        return 2
    mod = importlib.import_module(LM_ARCHS[args.arch])
    cfg = mod.SMOKE if args.smoke else mod.CONFIG
    skip = lm_cell_skip(cfg, args.shape)
    if skip:
        print(f"{args.arch} {args.shape}: skipped: {skip}")
        return 0
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    batch = args.batch or (LM_SMOKE_BATCH if args.smoke else cell["batch"])
    seq = args.seq or (LM_SMOKE_SEQ if args.smoke else cell["seq"])
    dev = resolve_device(args.device)
    model = init_lm_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    print(f"{args.arch} {args.shape}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}, batch {batch}, seq {seq}, kernels "
          f"{args.kernels}, on {dev}", flush=True)
    if cell["kind"] == "prefill":
        r = _lm_prefill(model, batch, seq, args.kernels,
                        warmup_seq=min(LM_WARMUP_SEQ, seq),
                        profile=args.profile)
        want = cfg.n_layers if (args.kernels == "kernel"
                                and dev.type == "cuda") else 0
        line = (f"  wall {r['wall_s']:.3f} s, {r['tokens_per_s']:.1f} "
                f"tokens/s")
        ok = r["finite"] and r["launches"] == want
        tail = (f"flash_attention launches {r['launches']} (want {want}), "
                f"finite {r['finite']}")
    else:
        r = _lm_decode(model, batch, seq, min(LM_DECODE_STEPS, seq),
                       args.kernels, profile=args.profile)
        line = (f"  {r['steps']} steps: p50 {r['p50_ms']:.3f} ms, p99 "
                f"{r['p99_ms']:.3f} ms a step, {r['tokens_per_s']:.1f} "
                f"tokens/s")
        ok = r["finite"]
        tail = f"finite {r['finite']}"
    if dev.type == "cuda":
        line += (f", {r['tflops']:.3f} TFLOP/s, peak device "
                 f"{r['peak_gb']:.2f} GB")
    print(f"{line}, {tail}")
    if args.profile:
        print(r["profile"])
    return 0 if ok else 1


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
    telemetry_port: Optional[int] = None,
    ledger: Optional[str] = None,
) -> dict:
    """Drive SSOEngine (serial + pipelined) for a GNN arch on ``device``
    (the CUDA card unless ``device="cpu"``); returns the check/stat dict.
    ``dims`` defaults to ``[24, 32, 8]`` (input, hidden..., output).
    ``telemetry_port`` serves live Prometheus metrics over the run at
    ``depth`` (its counters) while it runs; ``ledger`` appends a
    ``run_kind="train_offload_smoke"`` record of that run to that JSONL
    ledger when its losses and gradients are finite.

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
        server = None
        if telemetry_port is not None and d == depth:
            from repro_torch.obs.live import TelemetryServer
            server = TelemetryServer(c, port=telemetry_port).start()
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
            if server is not None:
                server.stop()
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
    if ledger and out["finite"]:
        from repro_torch.obs.ledger import RunLedger, make_record
        RunLedger(ledger).append(make_record(
            "train_offload_smoke",
            dict(model=model, depth=depth, gather_workers=gather_workers,
                 transfer_stage=transfer_stage, device_slots=device_slots,
                 dims=dims, n_nodes=n_nodes, n_parts=n_parts,
                 avg_degree=avg_degree, cache_mb=cache_mb, kernels=kernels,
                 epochs=epochs, mode=mode),
            dict(wall_s=out["wall_s"], loss=float(out["loss"])),
            counters=piped["counters"], watch={"wall_s": "lower"},
            backend=device.type,
        ))
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
                         "is recovered from the config naming convention), "
                         "two-tower-retrieval or phi3-medium-14b")
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
                         "SMOKE widths on the card; with an LM --shape, "
                         "that cell at the LM's SMOKE widths")
    ap.add_argument("--shape", default=None,
                    help="an LM cell: prefill_32k or decode_32k (train_4k "
                         "waits for LM training; long_500k is skipped for "
                         "full-attention archs)")
    ap.add_argument("--batch", type=int, default=None,
                    help="LM cells: batch (default: the cell's)")
    ap.add_argument("--seq", type=int, default=None,
                    help="LM cells: sequence / cache length (default: the "
                         "cell's)")
    ap.add_argument("--layers", type=int, default=None,
                    help="LM cells: depth (default: the config's)")
    ap.add_argument("--kernels", default="kernel",
                    choices=("kernel", "reference"),
                    help="LM cells: the prefill's attention route")
    ap.add_argument("--profile", action="store_true",
                    help="LM cells: one more prefill call / decode step "
                         "under torch.profiler; prints the device's busy "
                         "share and the top operators")
    ap.add_argument("--telemetry-port", type=int, default=None,
                    metavar="PORT",
                    help="serve live Prometheus metrics (GET /metrics) for "
                         "the duration of the --offload run (0 = ephemeral)")
    ap.add_argument("--ledger", nargs="?", const="RUNS/ledger.jsonl",
                    default=None, metavar="PATH",
                    help="append a run record of the --offload run to this "
                         "JSONL ledger (repro_torch.obs.ledger)")
    ap.add_argument("--device", default=None,
                    help="--offload and LM cells: the device (default: the "
                         "CUDA card; 'cpu' for a CPU run)")
    args = ap.parse_args(argv)
    if args.trace:
        import logging
        logging.basicConfig(level=logging.INFO,
                            format="%(name)s %(message)s")

    if args.arch in LM_ARCHS:
        sys.exit(_lm_main(args))
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
              f"(one of {sorted(GNN_ARCHS)}), one of {sorted(RECSYS_ARCHS)} "
              f"or one of {sorted(LM_ARCHS)}")
        sys.exit(2)
    model = GNN_ARCHS[args.arch]
    if not args.offload:
        print(f"{args.arch}: only --offload (the SSO engine) is ported")
        sys.exit(2)
    r = _train_smoke(
        model, args.pipeline_depth, args.gather_workers,
        transfer_stage=not args.no_transfer_stage,
        device_slots=args.device_slots, trace=args.trace,
        device=args.device, telemetry_port=args.telemetry_port,
        ledger=args.ledger,
    )
    r.pop("runs")
    print(f"{args.arch} offload smoke: {r}")
    if args.trace:
        print(f"trace written to {args.trace}")
    ok = r["finite"] and r["pipeline_matches_serial"] and dense_ok(r)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
