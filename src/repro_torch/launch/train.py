"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

The port's counterpart of ``python -m repro.launch.train``. ``--arch``
resolves through the registry (``repro_torch.configs.REGISTRY``); a GNN
arch's family is its ``GNNArch.model``. ``--list`` prints each registered
arch with its family and cells, as the reference's ``--list`` does.

``--smoke`` runs the arch's ``ArchSpec.smoke()`` (one loss and its
gradients at reduced widths) on the CUDA card, ``--device cpu`` on the
CPU, and prints ``loss``, ``grad_norm`` and ``finite``: for a GNN arch a
whole-graph forward on ``kronecker_graph(512, 6)``; for
``two-tower-retrieval`` the ``SMOKE`` widths with the kernel path held
against the reference path bitwise. A registered arch with neither
``--smoke`` nor ``--offload`` exits 2: the reference hands its full
configuration to the dry run, which comes with its slice of the port.

``--offload`` runs the storage-offloaded SSO training engine
(repro_torch/core/engine.py) for a GNN arch on a small synthetic graph on
the CUDA card — a serial and a pipelined run, each of ``epochs`` epochs
(forward, loss, backward) followed by an AdamW update — and checks that
the losses and gradients are finite and that the pipelined run equals the
serial one bitwise.

An LM id (``mixtral-8x7b``, ``deepseek-v2-236b``, ``phi3-medium-14b``,
``command-r-plus-104b``, ``deepseek-67b``) with ``--smoke`` and no
``--shape`` runs its ``ArchSpec.smoke()`` (``lm_loss`` and its gradients
at ``SMOKE``). With ``--shape`` it runs that cell at ``CONFIG`` widths on
the card, weights from ``torch.Generator`` seed 0 and tokens from numpy
seed 0: ``prefill_32k`` / ``decode_32k`` / ``long_500k`` the serving steps
(:func:`_lm_prefill`, :func:`_lm_decode`; ``--kernels`` routes a GQA
prefill's attention: ``n_layers`` ``flash_attention`` launches, none for
MLA, which attends through ``chunked_attention`` in both modes),
``train_4k`` ``--steps`` train steps of ``make_train_step`` on one batch
(:func:`_lm_train`). ``--batch`` and ``--layers`` cut a cell, and
``--seq`` a serving cell, or ``train_4k`` with ``--smoke``; ``--smoke``
runs at the ``SMOKE`` widths (batch 2, 64 tokens by default) and takes
``--device cpu``. Each prints wall, tokens/s, achieved TFLOP/s
(``lm_model_flops`` plus ``lm_attention_correction``) and peak device GB
(a train step each step, with its loss). A cell run with no cut of
depth or batch whose reckoned bytes (:func:`lm_cell_bytes`) exceed the
device's memory is refused before anything is allocated, with the
reckoning; a cut cell runs as asked (the reckoning is an upper one).
``long_500k`` (a decode step against a 524,288-position cache) runs for
a sliding-window arch (``mixtral-8x7b``) and is skipped for a
full-attention one, with the reference's reason.

Exit status 0 iff every check passes (or the cell is skipped); 1 when a
check fails or an uncut LM cell cannot fit; 2 for an unknown arch,
``--offload`` on a non-GNN arch, ``two-tower-retrieval`` without
``--smoke``, a GNN arch's full configuration (the dry run) and an LM id
without a shape or ``--smoke``.

With ``--offload``, ``--telemetry-port PORT`` serves live Prometheus
metrics (``GET /metrics``, :class:`~repro_torch.obs.live.TelemetryServer`;
0 picks a free port) over the requested depth's run, and ``--ledger
[PATH]`` appends one ``train_offload_smoke`` record
(:mod:`repro_torch.obs.ledger`, ``backend`` the device type) to that JSONL
ledger. ``--device cpu`` runs the smokes on the CPU.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from repro_torch.configs import REGISTRY
from repro_torch.launch.infer import _smoke_graph


def _rel_err(a, b) -> float:
    """max |a - b| / max |a| over two tensors (float64 on the host)."""
    import numpy as np

    a = a.detach().double().cpu().numpy()
    b = b.detach().double().cpu().numpy()
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-12))


def _recsys_smoke(device=None) -> dict:
    """``two-tower-retrieval``'s ``ArchSpec.smoke`` on ``device`` (the CUDA
    card unless ``device="cpu"``)."""
    return REGISTRY["two-tower-retrieval"].smoke(device=device)


# the prefill's warm-up length and the decode steps after the filled cache
LM_WARMUP_SEQ = 1024
LM_DECODE_STEPS = 32
# --smoke's default cut of an LM cell
LM_SMOKE_BATCH = 2
LM_SMOKE_SEQ = 64
# train_4k's steps on one batch
LM_TRAIN_STEPS = 3


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
    against a ``seq``-position KV cache (each of ``init_kv_cache``'s
    entries, MLA's latent ones included) whose first ``seq - steps``
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
    for c in cache.values():
        for layer in c:
            layer[:, :fill].copy_(torch.randn(
                (batch, fill) + tuple(layer.shape[2:]), generator=gen,
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


def lm_cell_bytes(cfg, kind: str, batch: int, seq: int) -> dict:
    """The device bytes an LM cell's step at ``cfg`` holds at its peak, by
    term. Every kind holds the parameters in ``cfg.dtype``, counted by the
    reference's ``param_count`` (which counts an MoE config's dense first
    layers as MoE layers and leaves out MLA's norms: at DeepSeek-V2's
    widths it is 3.63 G parameters above the real leaves, whatever the
    depth). A train step adds their gradients, AdamW's float32 ``m`` and
    ``v``, four float32 ``(batch, seq, vocab)`` tensors at the loss (the
    logits, their ``log_softmax`` and the two gradients), the head's
    float32 copy and its gradient, and each layer's saved input (per-layer
    remat); a layer's own activations, one layer's at a time under remat,
    are left out. A prefill adds one layer's working set: ``batch * seq``
    tokens at the residual stream plus the attention's q, k, v and output
    widths (``3 d_model`` for GQA; MLA's per-head ``2 (qk_nope_dim +
    qk_rope_dim) + 2 v_head_dim``) and the dense FFN's ``3 d_ff`` (an MoE
    config's ``d_ff_dense`` where it has dense layers, else none), and for
    an MoE config its expert buffers (``moe``: the ``G * E * C`` dispatch
    rows at ``d_model`` and ``3 d_ff_expert``) and the ``batch * seq *
    top_k`` token copies and gathered results at ``d_model``. A decode
    step adds every layer's cache (GQA's K and V, ``2 Hkv Dh`` a position;
    MLA's latent and rope key, ``kv_lora + qk_rope_dim``) and one layer's
    float32 copy of it. The reckoning is an upper one: at Phi-3-medium's
    widths, 4 layers and batch 2 of 4,096 tokens, a train step reckons
    46.29 GB and peaked at 36.90 GB on an H100 (PERF.md §4), so the
    launcher refuses on it only a cell run with no cut."""
    from repro_torch.models.lm.moe import moe_shape

    item = cfg.dtype.itemsize
    d = cfg.d_model
    n = cfg.param_count() + d                    # + the final norm
    out = dict(params=n * item)
    if kind == "train":
        out.update(
            grads=n * item, adamw=8 * n,
            logits=4 * 4 * batch * seq * cfg.vocab,
            head=2 * 4 * d * cfg.vocab,
            layer_inputs=cfg.n_layers * batch * seq * d * item)
    elif kind == "prefill":
        if cfg.attn_type == "mla":
            attn = cfg.n_heads * (2 * (cfg.qk_nope_dim + cfg.qk_rope_dim)
                                  + 2 * cfg.v_head_dim)
        else:
            attn = 3 * d
        m = cfg.moe
        ff = cfg.d_ff if m is None else (
            (m.d_ff_dense or cfg.d_ff) if cfg.n_dense else 0)
        tokens = batch * seq
        out["layer"] = tokens * (d + attn + 3 * ff) * item
        if m is not None:
            G, C = moe_shape(m, tokens)
            out["moe"] = (G * m.n_experts * C * (d + 3 * m.d_ff_expert)
                          + 2 * tokens * m.top_k * d) * item
    else:
        if cfg.attn_type == "mla":
            per = cfg.kv_lora + cfg.qk_rope_dim
        else:
            per = 2 * cfg.n_kv_heads * cfg.d_head
        kv = batch * seq * per
        out.update(cache=cfg.n_layers * kv * item, cache_f32=4 * kv)
    out["total"] = sum(out.values())
    return out


def _device_bytes(dev) -> int:
    """The device's memory: the card's total, or the host's physical
    memory for the CPU."""
    import os

    import torch

    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _lm_train(model, batch: int, seq: int, steps: int = LM_TRAIN_STEPS,
              seed: int = 0, profile: bool = False) -> dict:
    """``steps`` calls of ``make_train_step`` (lr 1e-4, AdamW in place)
    on ``model``'s device on one batch: tokens ``(batch, seq)`` uniform
    from numpy ``seed``. Returns each step's loss, MoE aux loss (0.0 for a
    dense config), wall (host clock, ending in a synchronise), tokens/s
    and achieved TFLOP/s (``lm_model_flops`` + ``lm_attention_correction``,
    remat's recompute not counted), the peak device GB since the optimizer
    state was made (it included), the steps' ``flash_attention``
    launches, and ``finite``: every loss, and every ``m`` and ``v`` leaf
    after each step (a non-finite gradient makes them so); with
    ``profile``, one more step under :func:`_profiled` (``profile``)."""
    import time

    import numpy as np
    import torch

    from repro_torch.configs.base import (
        lm_attention_correction, lm_model_flops,
    )
    from repro_torch.kernels import launch_counts
    from repro_torch.models.lm.steps import make_train_step
    from repro_torch.optim import adamw_init

    cfg, dev = model.cfg, model.device
    step = make_train_step(cfg, device=dev)[0]
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, seq)).astype(np.int32)).to(dev)
    opt = adamw_init(model)
    flops = (lm_model_flops(cfg, "train", batch, seq)
             + lm_attention_correction(cfg, "train", batch, seq)["flops"])
    _reset_peak(dev)
    before = launch_counts()["flash_attention"]
    losses, auxes, walls, finite = [], [], [], True
    for _ in range(steps):
        t0 = time.perf_counter()
        model, opt, metrics = step(model, opt, toks)
        loss = float(metrics["loss"])
        _sync(dev)
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        auxes.append(float(metrics["aux"]))
        finite &= bool(np.isfinite(loss)) and all(
            bool(torch.isfinite(t).all())
            for k in ("m", "v") for t in opt[k].values())
    out = dict(
        batch=batch, seq=seq, steps=steps, losses=losses, auxes=auxes,
        walls_s=walls,
        tokens_per_s=[batch * seq / w for w in walls],
        tflops=[flops / w / 1e12 for w in walls], peak_gb=_peak_gb(dev),
        launches=launch_counts()["flash_attention"] - before, finite=finite,
    )
    if profile:
        out["profile"] = _profiled(lambda: step(model, opt, toks), dev)
    return out


def _dry_run(args, arch) -> int:
    """A GNN id's full configuration: its cell's dry run on the 16 x 16
    production mesh (``launch/dryrun.py``, a process of its own), as the
    reference's launcher hands over; returns the dry run's exit code."""
    import subprocess

    from repro_torch.launch import dryrun

    shape = args.shape or arch.runnable_shapes()[0]
    print(f"{args.arch}: the full configuration runs on the production "
          f"mesh; its dry run ({shape}, 16x16) instead (--smoke or "
          f"--offload for a run here)", flush=True)
    cmd, env = dryrun.command(args.arch, shape, "single", args.device)
    r = subprocess.run(cmd, env=env, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True)
    print("\n".join(line for line in r.stdout.splitlines()
                    if line.startswith("[")))
    if r.returncode:
        print(r.stdout[-4000:])
    return r.returncode


def _lm_main(args, arch) -> int:
    """The LM branch of :func:`main`; returns the exit status."""
    import dataclasses

    import torch

    from repro_torch.configs.base import LM_SHAPES
    from repro_torch.device import resolve_device
    from repro_torch.models.lm.transformer import init_lm_params

    if args.offload:
        print(f"{args.arch}: --offload requires a GNN arch")
        return 2
    if args.shape is None:
        if args.smoke:
            r = arch.smoke(device=args.device)
            print(f"{args.arch} smoke: {r}")
            return 0 if r["finite"] and r["grad_norm"] > 0 else 1
        shapes = [s for s, c in arch.cells.items() if not c.skip]
        print(f"{args.arch}: no --shape given ({', '.join(shapes)}), and "
              f"no --smoke")
        return 2
    if args.shape not in LM_SHAPES:
        print(f"{args.arch}: unknown shape {args.shape!r} "
              f"(one of {sorted(LM_SHAPES)})")
        return 2
    cell = LM_SHAPES[args.shape]
    skip = arch.cells[args.shape].skip
    if skip:
        print(f"{args.arch} {args.shape}: skipped: {skip}")
        return 0
    train = cell["kind"] == "train"
    if train and args.seq and not args.smoke:
        print(f"{args.arch} {args.shape}: --seq cuts train_4k only with "
              f"--smoke (the cell's sequence is its shape)")
        return 2
    cfg = arch.smoke_config if args.smoke else arch.config
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    batch = args.batch or (LM_SMOKE_BATCH if args.smoke else cell["batch"])
    seq = args.seq or (LM_SMOKE_SEQ if args.smoke else cell["seq"])
    dev = resolve_device(args.device)
    need = lm_cell_bytes(cfg, cell["kind"], batch, seq)
    have = _device_bytes(dev)
    terms = ", ".join(f"{k} {v / 1e9:.2f}" for k, v in need.items()
                      if k != "total")
    if need["total"] > have:
        if not (args.layers or args.batch):
            print(f"{args.arch} {args.shape}: {cfg.n_layers} layers at batch "
                  f"{batch} x {seq} tokens need {need['total'] / 1e9:.2f} GB "
                  f"({terms} GB), more than the {have / 1e9:.2f} GB of "
                  f"{dev}; cut it with --layers / --batch")
            return 1
        print(f"{args.arch} {args.shape}: the cut cell reckons "
              f"{need['total'] / 1e9:.2f} GB ({terms} GB), more than the "
              f"{have / 1e9:.2f} GB of {dev}; the reckoning is an upper "
              f"one, so it runs as asked", flush=True)
    model = init_lm_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    print(f"{args.arch} {args.shape}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}, batch {batch}, seq {seq}, "
          + ("" if train else f"kernels {args.kernels}, ") + f"on {dev}",
          flush=True)
    if train:
        r = _lm_train(model, batch, seq, args.steps, profile=args.profile)
        for i, (loss, aux, w, tps, tf) in enumerate(zip(
                r["losses"], r["auxes"], r["walls_s"], r["tokens_per_s"],
                r["tflops"])):
            line = (f"  step {i + 1}: loss {loss:.6f}, aux {aux:.6f}, wall "
                    f"{w:.3f} s, {tps:.1f} tokens/s")
            if dev.type == "cuda":
                line += f", {tf:.3f} TFLOP/s"
            print(line)
        ok = r["finite"] and r["launches"] == 0
        line = (f"  {r['steps']} steps: loss {r['losses'][0]:.6f} -> "
                f"{r['losses'][-1]:.6f}")
        tail = (f"flash_attention launches {r['launches']} (want 0), "
                f"finite {r['finite']}")
    elif cell["kind"] == "prefill":
        r = _lm_prefill(model, batch, seq, args.kernels,
                        warmup_seq=min(LM_WARMUP_SEQ, seq),
                        profile=args.profile)
        # MLA attends through chunked_attention in both modes
        want = cfg.n_layers if (args.kernels == "kernel"
                                and cfg.attn_type == "gqa"
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
        if not train:
            line += f", {r['tflops']:.3f} TFLOP/s"
        line += f", peak device {r['peak_gb']:.2f} GB"
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
    ap.add_argument("--arch", default=None,
                    help="an arch id of the registry (--list)")
    ap.add_argument("--list", action="store_true",
                    help="print the registered archs and their cells")
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
                    help="the arch's reduced configuration: one loss and "
                         "gradient (ArchSpec.smoke); with an LM --shape, "
                         "that cell at the LM's SMOKE widths")
    ap.add_argument("--shape", default=None,
                    help="an LM cell: train_4k, prefill_32k, decode_32k or "
                         "long_500k (a decode cell; skipped for "
                         "full-attention archs)")
    ap.add_argument("--batch", type=int, default=None,
                    help="LM cells: batch (default: the cell's)")
    ap.add_argument("--seq", type=int, default=None,
                    help="LM cells: sequence / cache length (default: the "
                         "cell's; train_4k only with --smoke)")
    ap.add_argument("--steps", type=int, default=LM_TRAIN_STEPS,
                    help="train_4k: train steps on one batch")
    ap.add_argument("--layers", type=int, default=None,
                    help="LM cells: depth (default: the config's)")
    ap.add_argument("--kernels", default="kernel",
                    choices=("kernel", "reference"),
                    help="LM cells: the prefill's attention route")
    ap.add_argument("--profile", action="store_true",
                    help="LM cells: one more train step / prefill call / "
                         "decode step under torch.profiler; prints the "
                         "device's busy share and the top operators")
    ap.add_argument("--telemetry-port", type=int, default=None,
                    metavar="PORT",
                    help="serve live Prometheus metrics (GET /metrics) for "
                         "the duration of the --offload run (0 = ephemeral)")
    ap.add_argument("--ledger", nargs="?", const="RUNS/ledger.jsonl",
                    default=None, metavar="PATH",
                    help="append a run record of the --offload run to this "
                         "JSONL ledger (repro_torch.obs.ledger)")
    ap.add_argument("--device", default=None,
                    help="--offload, --smoke and LM cells: the device "
                         "(default: the CUDA card; 'cpu' for a CPU run)")
    args = ap.parse_args(argv)
    if args.trace:
        import logging
        logging.basicConfig(level=logging.INFO,
                            format="%(name)s %(message)s")

    if args.list:
        for name, arch in REGISTRY.items():
            shapes = ", ".join(
                s + (" [skip]" if c.skip else "")
                for s, c in arch.cells.items()
            )
            print(f"{name:24s} [{arch.family}] {shapes}")
        return
    if args.arch is None:
        ap.error("--arch is required (or --list)")
    arch = REGISTRY.get(args.arch)
    if arch is None:
        gnn = sorted(n for n, a in REGISTRY.items() if a.family == "gnn")
        print(f"{args.arch}: not a registered arch; training requires a GNN "
              f"arch (one of {gnn}) or one of {sorted(REGISTRY)}")
        sys.exit(2)
    if arch.family == "lm":
        sys.exit(_lm_main(args, arch))
    if arch.family == "recsys":
        if args.offload or not args.smoke:
            print(f"{args.arch}: only --smoke is ported for recsys archs "
                  f"(--offload needs a GNN arch)")
            sys.exit(2)
        r = arch.smoke(device=args.device)
        print(f"{args.arch} smoke: {r}")
        ok = r["finite"] and r["kernel_matches_reference"] and r["launches_ok"]
        sys.exit(0 if ok else 1)
    if args.smoke and not args.offload:
        r = arch.smoke(device=args.device)
        print(f"{args.arch} smoke: {r}")
        sys.exit(0 if r["finite"] and r["grad_norm"] > 0 else 1)
    if not args.offload:
        sys.exit(_dry_run(args, arch))
    model = arch.config.model
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
