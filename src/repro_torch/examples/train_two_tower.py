"""End-to-end driver: train a ~135M-parameter two-tower retrieval model for
a few hundred steps with the fault-tolerant loop (checkpoint/resume,
straggler logging) — the port of ``examples/train_two_tower.py``.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_two_tower [--steps 300]

On the CUDA card unless ``--device cpu``. Each step's batch is a pure
function of the step number, so a resumed run repeats the same batches.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.recsys.two_tower import (
    TwoTowerConfig, init_two_tower, two_tower_value_and_grad,
)
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.train.loop import LoopConfig, run_training_loop


def make_config(vocab: int) -> TwoTowerConfig:
    """The example's model: the published widths, bags of 8, ``vocab`` rows
    in each table."""
    return TwoTowerConfig(
        embed_dim=256, tower_mlp=(1024, 512, 256),
        n_user_fields=8, n_item_fields=4, bag_size=8,
        user_vocab=vocab, item_vocab=vocab,
    )


def make_batch_fn(cfg: TwoTowerConfig, batch: int, vocab: int,
                  device) -> Callable:
    """``batch_fn(step) -> (user_ids, item_ids)`` on ``device``, int32:
    ``batch`` random base ids (numpy seed ``step``), each user's every bag
    slot the base id, each item's too except 30% replaced by noise ids —
    correlated users and items, so there is something to learn."""

    def batch_fn(step: int):
        r = np.random.default_rng(step)  # deterministic per step (resumable)
        base = r.integers(0, vocab, (batch,))
        u = np.stack([base] * cfg.n_user_fields, 1)[:, :, None].repeat(
            cfg.bag_size, 2
        )
        i = np.stack([base] * cfg.n_item_fields, 1)[:, :, None].repeat(
            cfg.bag_size, 2
        )
        noise = r.integers(0, vocab, i.shape)
        i = np.where(r.random(i.shape) < 0.3, noise, i)
        return (torch.from_numpy(u.astype(np.int32)).to(device),
                torch.from_numpy(i.astype(np.int32)).to(device))

    return batch_fn


def make_step_fn(cfg: TwoTowerConfig, lr: float = 1e-3) -> Callable:
    """``step_fn(params, opt_state, batch) -> (params, opt_state,
    {"loss", "acc"})``: the in-batch softmax loss's gradients and one AdamW
    update."""

    def step_fn(params, opt, batch):
        u, i = batch
        (loss, acc), grads = two_tower_value_and_grad(params, u, i, cfg)
        params, opt = adamw_update(grads, params, opt, lr=lr)
        return params, opt, {"loss": loss, "acc": acc}

    return step_fn


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=250_000)
    ap.add_argument("--ckpt",
                    default=os.path.join(tempfile.gettempdir(),
                                         "two_tower_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = make_config(args.vocab)
    params = init_two_tower(cfg, torch.Generator(device).manual_seed(0),
                            device)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"two-tower model: {n_params/1e6:.1f}M parameters "
          f"(tables {2*args.vocab*cfg.embed_dim/1e6:.0f}M)")
    opt = adamw_init(params)

    loop_cfg = LoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt, ckpt_every=100,
        log_every=20,
    )
    params, opt, state = run_training_loop(
        loop_cfg, params, opt, make_step_fn(cfg),
        make_batch_fn(cfg, args.batch, args.vocab, device),
    )
    if state.losses:
        print(f"finished at step {state.step}; loss "
              f"{state.losses[0]:.4f} -> {state.losses[-1]:.4f}; "
              f"stragglers: {state.stragglers}")
    return params, opt, state


if __name__ == "__main__":
    main()
