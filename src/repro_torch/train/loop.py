"""Fault-tolerant training loop (the port's ``train/loop.py``).

Production behaviors implemented (and unit-tested):
- periodic atomic checkpoints + resume-from-latest (params, opt state, data
  cursor, RNG key) — a killed job restarts bit-exact;
- preemption safety: SIGTERM/SIGINT trigger a final checkpoint before exit;
- straggler detection: per-step wall-time EWMA; steps slower than
  ``straggler_factor`` × EWMA are logged with their step index (on real
  multi-host deployments this feeds the scheduler's hot-spare swap);
- deterministic data pipeline cursor so restore replays the exact batch
  sequence;
- :func:`run_epoch_loop`: the full-graph (SSO-offload) variant — one
  checkpoint per epoch boundary, so a job SIGKILLed mid-epoch resumes from
  the last completed epoch and finishes bit-identical to an uninterrupted
  run (verified by the kill-mid-epoch test).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, List, Optional

import torch

from repro_torch.train.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint,
)


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    straggler_factor: float = 2.0
    ewma_beta: float = 0.9
    log_every: int = 10


@dataclasses.dataclass
class LoopState:
    step: int = 0
    ewma_step_s: float = 0.0
    stragglers: List[int] = dataclasses.field(default_factory=list)
    losses: List[float] = dataclasses.field(default_factory=list)


def run_training_loop(
    cfg: LoopConfig,
    params,
    opt_state,
    step_fn: Callable,          # (params, opt_state, batch) -> (p, o, metrics)
    batch_fn: Callable,         # (cursor:int) -> batch  (deterministic)
    log_fn: Callable[[str], None] = print,
    resume: bool = True,
):
    state = LoopState()
    start = 0
    if cfg.ckpt_dir and resume:
        path = latest_checkpoint(cfg.ckpt_dir)
        if path:
            params, opt_state, start, extra = restore_checkpoint(
                path, params, opt_state
            )
            state.step = start
            log_fn(f"[loop] resumed from {path} at step {start}")

    interrupted = {"flag": False}

    def _handler(signum, frame):
        interrupted["flag"] = True
        log_fn(f"[loop] signal {signum}: checkpointing before exit")

    old_term = signal.signal(signal.SIGTERM, _handler)
    old_int = signal.signal(signal.SIGINT, _handler)
    try:
        for step in range(start, cfg.total_steps):
            t0 = time.perf_counter()
            batch = batch_fn(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            loss = metrics.get("loss") if isinstance(metrics, dict) else metrics
            loss = float(loss.item() if isinstance(loss, torch.Tensor)
                         else loss)
            dt = time.perf_counter() - t0
            state.losses.append(loss)
            # straggler detection on step-time EWMA
            if state.ewma_step_s == 0.0:
                state.ewma_step_s = dt
            else:
                if dt > cfg.straggler_factor * state.ewma_step_s:
                    state.stragglers.append(step)
                    log_fn(
                        f"[loop] straggler step {step}: {dt:.3f}s vs "
                        f"EWMA {state.ewma_step_s:.3f}s"
                    )
                state.ewma_step_s = (
                    cfg.ewma_beta * state.ewma_step_s
                    + (1 - cfg.ewma_beta) * dt
                )
            state.step = step + 1
            if step % cfg.log_every == 0:
                log_fn(f"[loop] step {step} loss {loss:.5f} ({dt:.3f}s)")
            should_ckpt = (
                cfg.ckpt_dir
                and ((step + 1) % cfg.ckpt_every == 0 or interrupted["flag"])
            )
            if should_ckpt:
                save_checkpoint(
                    cfg.ckpt_dir, step + 1, params, opt_state,
                    extra={"cursor": step + 1},
                )
            if interrupted["flag"]:
                break
    finally:
        signal.signal(signal.SIGTERM, old_term)
        signal.signal(signal.SIGINT, old_int)
    return params, opt_state, state


@dataclasses.dataclass
class EpochLoopConfig:
    """Knobs for :func:`run_epoch_loop` (full-graph offloaded training).

    Unlike :class:`LoopConfig`'s step granularity, full-graph training's
    natural recovery point is the epoch boundary: one epoch = one exact
    (loss, grads) over the whole graph, so params after epoch *k* are a
    pure function of the initial state — replaying from any epoch-boundary
    checkpoint is bit-identical."""

    epochs: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 1
    keep: int = 3
    log_every: int = 1


def run_epoch_loop(
    cfg: EpochLoopConfig,
    params,
    opt_state,
    epoch_fn: Callable,    # (params, epoch:int) -> (loss, grads)
    update_fn: Callable,   # (grads, params, opt_state) -> (params, opt_state)
    log_fn: Callable[[str], None] = print,
    resume: bool = True,
):
    """Epoch-boundary checkpointed loop for storage-offloaded full-graph
    training. ``epoch_fn`` is typically a closure over a live ``SSOEngine``
    (``lambda p, e: engine.run_epoch(p, labels)``); the engine's storage
    state is rebuilt from the inputs on restart, so nothing below the
    params/opt-state needs to survive a crash.

    Saves atomically every ``ckpt_every`` epochs; with ``resume`` the loop
    restarts from the newest *complete* checkpoint (torn saves are skipped
    by ``latest_checkpoint``) and replays the remaining epochs — final
    params are bit-identical to an uninterrupted run because each epoch is
    deterministic given its input params.

    Returns ``(params, opt_state, losses)`` with ``losses`` covering every
    epoch from 0 (restored epochs included, carried in the checkpoint's
    ``extra``)."""
    start = 0
    losses: List[float] = []
    if cfg.ckpt_dir and resume:
        path = latest_checkpoint(cfg.ckpt_dir)
        if path:
            params, opt_state, start, extra = restore_checkpoint(
                path, params, opt_state
            )
            losses = [float(x) for x in extra.get("losses", [])]
            log_fn(f"[epoch-loop] resumed from {path} at epoch {start}")
    for epoch in range(start, cfg.epochs):
        t0 = time.perf_counter()
        loss, grads = epoch_fn(params, epoch)
        params, opt_state = update_fn(grads, params, opt_state)
        losses.append(float(loss))
        if epoch % cfg.log_every == 0:
            log_fn(
                f"[epoch-loop] epoch {epoch} loss {losses[-1]:.6f} "
                f"({time.perf_counter() - t0:.3f}s)"
            )
        if cfg.ckpt_dir and (epoch + 1) % cfg.ckpt_every == 0:
            save_checkpoint(
                cfg.ckpt_dir, epoch + 1, params, opt_state,
                extra={"losses": losses}, keep=cfg.keep,
            )
    return params, opt_state, losses
