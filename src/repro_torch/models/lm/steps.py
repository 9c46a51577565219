"""Prefill and decode step builders for the LM (the reference's
``models/lm/steps.py``, its serving part, without a mesh).

Each builder resolves its device (the CUDA card unless ``device="cpu"``)
and returns a step that takes the model first; the steps run without
autograd. Training (``make_train_step``: ``lm_loss``, AdamW over 14 B
parameters, a backward through attention) comes with its own slice.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm.attention import KERNEL_MODES
from repro_torch.models.lm.transformer import (
    LM, LMConfig, lm_decode_step, lm_hidden, lm_logits,
)


def _checked(cfg: LMConfig, kernels: str, device: DeviceLike):
    if kernels not in KERNEL_MODES:
        raise ValueError(f"kernels={kernels!r} not in {KERNEL_MODES}")
    device = resolve_device(device)

    def check(model: LM) -> None:
        if model.cfg != cfg:
            raise ValueError(f"the model is {model.cfg.name!r} "
                             f"({model.cfg}), the step {cfg}")
        if model.device != device:
            raise ValueError(f"the model is on {model.device}, the step on "
                             f"{device}")

    return device, check


def make_prefill_step(cfg: LMConfig, kernels: str = "kernel",
                      device: DeviceLike = None
                      ) -> Callable[[LM, torch.Tensor], torch.Tensor]:
    """``prefill_step(model, tokens (B, S)) -> logits (B, vocab)`` float32
    at the last position: the forward over the prompt, its attention
    routed by ``kernels`` ("kernel": the ``flash_attention`` kernel;
    "reference": the plain ``chunked_attention``). The final norm and the
    head act row by row, so applying them to the last position alone is
    the reference's ``lm_forward(...)[0][:, -1]`` without its (B, S, vocab)
    float32 logits (13 GB at 32k tokens)."""
    device, check = _checked(cfg, kernels, device)

    @torch.no_grad()
    def prefill_step(model: LM, tokens: torch.Tensor) -> torch.Tensor:
        check(model)
        x = lm_hidden(model, tokens.to(device), kernels)
        return lm_logits(model, x[:, -1])

    return prefill_step


def make_decode_step(cfg: LMConfig, kernels: str = "kernel",
                     device: DeviceLike = None
                     ) -> Callable[..., Tuple[torch.Tensor,
                                              Dict[str, torch.Tensor]]]:
    """``decode_step(model, cache, token (B, 1), cache_len) -> (logits (B,
    vocab), cache)``: one greedy KV-cached step, the cache updated in
    place. The reference's decode reaches no Pallas kernel, so both
    ``kernels`` modes run the plain ``decode_attention``."""
    device, check = _checked(cfg, kernels, device)

    @torch.no_grad()
    def decode_step(model: LM, cache: Dict[str, torch.Tensor],
                    token: torch.Tensor, cache_len: int):
        check(model)
        return lm_decode_step(model, cache, token.to(device), cache_len)

    return decode_step
