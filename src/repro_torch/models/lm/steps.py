"""Train, prefill and decode step builders for the LM, and their
abstract inputs (the reference's ``models/lm/steps.py``).

Each builder resolves its device (the CUDA card unless ``device="cpu"``)
and returns a step that takes the model first. The serving steps run
without autograd; the train step takes one gradient of ``lm_loss`` and
applies AdamW in place (the reference's train step donates its parameters
and optimizer state). The ``lm_*_inputs`` functions give a step's
arguments as ``meta``-device tensors (shapes and dtypes, no memory) and
their placements over a ``("data", "model")`` ``DeviceMesh``
(``models/lm/sharding.py``), as the registry's builds hand them out.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm.attention import KERNEL_MODES
from repro_torch.models.lm.sharding import (
    batch_spec, kv_cache_specs, param_specs, placements, replicated,
)
from repro_torch.models.lm.transformer import (
    LM, LMConfig, init_kv_cache, lm_decode_step, lm_hidden, lm_logits,
    lm_value_and_grad,
)
from repro_torch.optim.adamw import adamw_init, adamw_update_


def abstract_params(cfg: LMConfig) -> LM:
    """An :class:`LM` of ``cfg`` on the ``meta`` device."""
    return LM(cfg, device="meta")


def abstract_opt_state(cfg: LMConfig) -> dict:
    """``adamw_init`` of :func:`abstract_params`: float32 ``m`` / ``v`` a
    parameter and the int32 step, on the ``meta`` device."""
    return adamw_init(abstract_params(cfg))


def _opt_placements(pshard, mesh):
    return {"m": pshard, "v": pshard, "step": replicated(mesh)}


def _checked(cfg: LMConfig, kernels: Optional[str], device: DeviceLike):
    if kernels is not None and kernels not in KERNEL_MODES:
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


def make_train_step(cfg: LMConfig, mesh=None, lr: float = 1e-4,
                    device: DeviceLike = None):
    """``train_step(model, opt_state, tokens (B, S)) -> (model, opt_state,
    {"loss", "ce", "aux"})``: one gradient of ``lm_loss`` (the plain
    ``chunked_attention``, each KV step and, with ``cfg.remat``, each layer
    checkpointed) and one AdamW step at ``lr`` applied in place
    (``adamw_update_``: bitwise ``adamw_update``'s, one leaf's temporaries
    at a time). The model and ``opt_state`` come back as the same objects.

    Returns the reference's ``(train_step, (pshard, oshard), pshard,
    oshard)``: the parameters' placements over ``mesh``
    (:func:`~repro_torch.models.lm.sharding.param_specs`), and the
    optimizer state's (``m`` and ``v`` as the parameters, ``step``
    replicated); both None without a mesh. The step runs on ``device``
    (the CUDA card unless ``device="cpu"``)."""
    device, check = _checked(cfg, None, device)

    def train_step(model: LM, opt_state: dict, tokens: torch.Tensor):
        check(model)
        (loss, (ce, aux)), grads = lm_value_and_grad(model, tokens.to(device))
        adamw_update_(grads, model, opt_state, lr=lr)
        return model, opt_state, {"loss": loss, "ce": ce, "aux": aux}

    pshard = oshard = None
    if mesh is not None:
        pshard = param_specs(abstract_params(cfg), mesh)
        oshard = _opt_placements(pshard, mesh)
    return train_step, (pshard, oshard), pshard, oshard


def make_prefill_step(cfg: LMConfig, kernels: str = "kernel",
                      device: DeviceLike = None
                      ) -> Callable[[LM, torch.Tensor], torch.Tensor]:
    """``prefill_step(model, tokens (B, S)) -> logits (B, vocab)`` float32
    at the last position: the forward over the prompt, its GQA attention
    routed by ``kernels`` ("kernel": the ``flash_attention`` kernel;
    "reference": the plain ``chunked_attention``; MLA takes the plain one
    in both). The final norm and the
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


def _tokens(batch: int, seq: int) -> torch.Tensor:
    return torch.empty((batch, seq), dtype=torch.int32, device="meta")


def lm_train_inputs(cfg: LMConfig, batch: int, seq: int, mesh):
    """``(params, opt_state, tokens)`` on the ``meta`` device and their
    placements: the parameters' (``param_specs``), the optimizer state's,
    the tokens' (batch over the data dims)."""
    p_abs = abstract_params(cfg)
    pshard = param_specs(p_abs, mesh)
    return (p_abs, adamw_init(p_abs), _tokens(batch, seq)), (
        pshard, _opt_placements(pshard, mesh),
        placements(mesh, batch_spec(batch, mesh)),
    )


def lm_prefill_inputs(cfg: LMConfig, batch: int, seq: int, mesh):
    """``(params, tokens)`` on the ``meta`` device and their placements."""
    p_abs = abstract_params(cfg)
    return (p_abs, _tokens(batch, seq)), (
        param_specs(p_abs, mesh), placements(mesh, batch_spec(batch, mesh)))


def lm_decode_inputs(cfg: LMConfig, batch: int, seq_len: int, mesh):
    """``(params, cache, token (B, 1), cache_len ())`` on the ``meta``
    device and their placements: the caches' by ``kv_cache_specs``, the
    token's over the data dims, ``cache_len`` replicated."""
    p_abs = abstract_params(cfg)
    cache = init_kv_cache(cfg, batch, seq_len, device="meta")
    clen = torch.empty((), dtype=torch.int32, device="meta")
    return (p_abs, cache, _tokens(batch, 1), clen), (
        param_specs(p_abs, mesh), kv_cache_specs(cache, mesh, batch),
        placements(mesh, batch_spec(batch, mesh)), replicated(mesh),
    )
