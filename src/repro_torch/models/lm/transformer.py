"""Decoder-only transformer, dense GQA with RoPE and SwiGLU (the
reference's ``models/lm/transformer.py``, its dense part): the prefill
forward through the ``flash_attention`` kernel, greedy KV-cached decode,
and training's :func:`lm_loss` with per-layer rematerialisation.

The reference stacks the layers' parameters along a leading L axis for one
``jax.lax.scan``; here each layer is an :class:`LMBlock` in an
``nn.ModuleList``, so initialising a 14 B-parameter model on the card makes
one layer's float32 temporaries at a time, never an L-stacked one. The
weights keep the reference's einsum layouts (``wq (d, H, Dh)``, ``wo (H,
Dh, d)``, ``w_gate (d, ff)``, ``lm_head (d, V)``, ...), so converting
between the two is a stack or an unstack (``repro_torch.params``).

The parameters do not require gradients, so serving builds no autograd
graph whatever the grad mode. Training asks for them:
:func:`lm_value_and_grad` switches ``requires_grad`` on for the one
gradient it takes and off again. Training attends through the plain
``chunked_attention`` (the reference's training path; the
``flash_attention`` kernel is forward-only) and, with ``LMConfig.remat``,
runs each layer under a non-reentrant ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of its scan body). MoE FFNs and MLA
attention raise :class:`NotImplementedError` in :class:`LMConfig`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm.attention import attention, decode_attention
from repro_torch.models.lm.layers import apply_rope, init_dense, rmsnorm, swiglu


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    attn_type: str = "gqa"          # "gqa" only ("mla" waits for DeepSeek-V2)
    window: Optional[int] = None    # sliding-window attention
    moe: Any = None                 # waits for Mixtral / DeepSeek-V2
    rope_theta: float = 1e4
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True              # checkpoint each layer in training
    q_chunk: int = 512              # chunked_attention's blocks
    kv_chunk: int = 1024
    # The reference unrolls its layer scan into a Python loop with this
    # (the dry run's cost calibration). The port's layers are always a
    # Python loop, its unrolled path, so the flag changes nothing here; it
    # is kept so that make_lm_arch's build(unroll=...) gives the
    # reference's config.
    unroll_layers: bool = False

    def __post_init__(self):
        if self.attn_type == "mla":
            raise NotImplementedError(
                "MLA attention (DeepSeek-V2) comes with that model's slice "
                "of the port")
        if self.attn_type != "gqa":
            raise ValueError(f"attn_type={self.attn_type!r} not in ('gqa',)")
        if self.moe is not None:
            raise NotImplementedError(
                "MoE FFNs (models/lm/moe.py: Mixtral, DeepSeek-V2) come with "
                "their slice of the port")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads={self.n_heads} is not a multiple of "
                             f"n_kv_heads={self.n_kv_heads}")

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (sliding window => O(S * W))."""
        return self.window is not None

    def param_count(self) -> int:
        d = self.d_model
        per = 2 * d                                             # norms
        per += d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
        per += self.n_heads * self.d_head * d
        per += 3 * d * self.d_ff
        return self.vocab * d * 2 + per * self.n_layers         # + embed, head

    def active_param_count(self) -> int:
        return self.param_count()


def _empty(shape, cfg: LMConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device),
                        requires_grad=False)


def _ones(n: int, cfg: LMConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(n, dtype=cfg.dtype, device=device),
                        requires_grad=False)


class LMBlock(nn.Module):
    """One layer's parameters, in the reference's layouts."""

    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        d, H, Hkv, Dh, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.d_head, cfg.d_ff)
        self.attn_norm = _ones(d, cfg, device)
        self.ffn_norm = _ones(d, cfg, device)
        self.wq = _empty((d, H, Dh), cfg, device)
        self.wk = _empty((d, Hkv, Dh), cfg, device)
        self.wv = _empty((d, Hkv, Dh), cfg, device)
        self.wo = _empty((H, Dh, d), cfg, device)
        self.w_gate = _empty((d, ff), cfg, device)
        self.w_up = _empty((d, ff), cfg, device)
        self.w_down = _empty((ff, d), cfg, device)


class LM(nn.Module):
    """The model's parameters on ``device`` (the CUDA card unless
    ``device="cpu"``), uninitialised except the norms (ones): fill them
    with :func:`init_lm_params` or ``repro_torch.params.lm_from_jax``."""

    def __init__(self, cfg: LMConfig, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = _empty((cfg.vocab, cfg.d_model), cfg, device)
        self.layers = nn.ModuleList(LMBlock(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _ones(cfg.d_model, cfg, device)
        self.lm_head = _empty((cfg.d_model, cfg.vocab), cfg, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device


def init_lm_params(cfg: LMConfig, generator: torch.Generator,
                   device: DeviceLike = None) -> LM:
    """An :class:`LM` on ``device`` with the reference's initialisation
    (``init_dense``: normals times ``1 / sqrt(fan-in)``; the embedding times
    0.02; ``wo`` times ``1 / sqrt(H * Dh)``; norms ones), drawn from
    ``generator``, which must lie on ``device``: embedding, head, then each
    layer's ``wq, wk, wv, wo, w_gate, w_up, w_down``. One tensor's float32
    draw at a time."""
    model = LM(cfg, device)
    dev = model.device

    def fill(p: nn.Parameter, scale: Optional[float] = None) -> None:
        p.copy_(init_dense(generator, p.shape, scale=scale,
                           dtype=cfg.dtype, device=dev))

    with torch.no_grad():
        fill(model.embed, 0.02)
        fill(model.lm_head)
        for blk in model.layers:
            for p in (blk.wq, blk.wk, blk.wv):
                fill(p)
            fill(blk.wo, 1.0 / (cfg.n_heads * cfg.d_head) ** 0.5)
            for p in (blk.w_gate, blk.w_up, blk.w_down):
                fill(p)
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhe->bshe", h, w)`` as one matrix product."""
    d, H, E = w.shape
    return torch.matmul(h, w.reshape(d, H * E)).view(*h.shape[:-1], H, E)


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshe,hed->bsd", o, wo)`` as one matrix product."""
    H, E, d = wo.shape
    return torch.matmul(o.reshape(*o.shape[:-2], H * E), wo.reshape(H * E, d))


def _attn_block(blk: LMBlock, x: torch.Tensor, positions: torch.Tensor,
                cfg: LMConfig, kernels: str) -> torch.Tensor:
    h = rmsnorm(x, blk.attn_norm)
    q = apply_rope(_proj(h, blk.wq), positions, cfg.rope_theta)
    k = apply_rope(_proj(h, blk.wk), positions, cfg.rope_theta)
    v = _proj(h, blk.wv)
    o = attention(q, k, v, causal=True, window=cfg.window,
                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk, kernels=kernels)
    return _out_proj(o, blk.wo)


def _ffn_block(blk: LMBlock, x: torch.Tensor) -> torch.Tensor:
    return swiglu(rmsnorm(x, blk.ffn_norm), blk.w_gate, blk.w_up, blk.w_down)


def _layer_fwd(blk: LMBlock, x: torch.Tensor, positions: torch.Tensor,
               cfg: LMConfig, kernels: str) -> torch.Tensor:
    x = x + _attn_block(blk, x, positions, cfg, kernels)
    return x + _ffn_block(blk, x)


def _embed(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    if tokens.device != model.device:
        raise ValueError(f"tokens are on {tokens.device}, the model on "
                         f"{model.device}")
    return model.embed[tokens.long()].to(model.cfg.dtype)


def lm_hidden(model: LM, tokens: torch.Tensor,
              kernels: str = "kernel") -> torch.Tensor:
    """tokens ``(B, S)`` -> the residual stream after the last layer,
    ``(B, S, d_model)`` in the model's dtype (before the final norm). With
    ``cfg.remat`` and grad mode on, each layer runs under a checkpoint: the
    backward keeps only each layer's input and recomputes the rest."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = _embed(model, tokens)
    remat = model.cfg.remat and torch.is_grad_enabled()
    for blk in model.layers:
        if remat:
            # the layer draws no random numbers: no RNG state to stash
            x = checkpoint(_layer_fwd, blk, x, positions, model.cfg, kernels,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer_fwd(blk, x, positions, model.cfg, kernels)
    return x


def lm_logits(model: LM, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the head, in float32: ``(..., d)`` -> ``(..., V)``.
    Both act row by row, so they may be given any subset of positions."""
    x = rmsnorm(x, model.final_norm)
    return torch.matmul(x.float(), model.lm_head.float())


def lm_forward(model: LM, tokens: torch.Tensor,
               kernels: str = "kernel") -> Tuple[torch.Tensor, float]:
    """tokens ``(B, S)`` -> logits ``(B, S, vocab)`` float32, and the MoE
    auxiliary loss (0.0: the FFNs are dense). ``kernels`` routes the
    attention (:func:`~repro_torch.models.lm.attention.attention`)."""
    return lm_logits(model, lm_hidden(model, tokens, kernels)), 0.0


def lm_loss(model: LM, tokens: torch.Tensor, aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, float]]:
    """Next-token cross-entropy, the tokens doubling as shifted targets:
    ``log_softmax`` of the float32 logits at positions ``:-1`` against
    ``tokens[:, 1:]``, the mean of the negated picks (the reference's
    ``lm_loss``, in its order). Returns ``(loss + aux_weight * aux, (loss,
    aux))``; aux is 0.0 with dense FFNs. The attention is the plain
    ``chunked_attention``, with each KV step checkpointed under grad mode,
    and with ``cfg.remat`` each layer is checkpointed too."""
    logits, aux = lm_forward(model, tokens, kernels="reference")
    tgt = tokens[:, 1:].long()
    lp = F.log_softmax(logits[:, :-1], dim=-1)
    ll = torch.gather(lp, -1, tgt[..., None])
    loss = -ll.mean()
    return loss + aux_weight * aux, (loss, aux)


@contextlib.contextmanager
def _requiring_grad(model: LM):
    """The model's parameters require grad inside, and not after."""
    params = list(model.parameters())
    try:
        for p in params:
            p.requires_grad_(True)
        yield params
    finally:
        for p in params:
            p.requires_grad_(False)


def lm_value_and_grad(model: LM, tokens: torch.Tensor,
                      aux_weight: float = 0.01):
    """``jax.value_and_grad(lm_loss, has_aux=True)`` on the port: returns
    ``(loss, (ce, aux))`` detached and ``{parameter name: gradient}`` in
    ``named_parameters`` order, each in its parameter's dtype. Grad mode
    is on inside, whatever the caller's."""
    names = [n for n, _ in model.named_parameters()]
    with torch.enable_grad(), _requiring_grad(model) as params:
        loss, (ce, aux) = lm_loss(model, tokens, aux_weight)
        grads = torch.autograd.grad(loss, params)
    return (loss.detach(), (ce.detach(), aux)), dict(zip(names, grads))


# ---------------------------------------------------------------------------
# decode (KV-cached)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: LMConfig, batch: int, max_len: int,
                  dtype: Optional[torch.dtype] = None,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zeroed ``{"k", "v"}`` caches, each ``(L, batch, max_len, Hkv, Dh)``
    in ``dtype`` (the model's by default) on ``device`` (the CUDA card
    unless ``device="cpu"``): the reference's ``cache["scan"]``."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _gqa_decode_layer(blk: LMBlock, x: torch.Tensor, kc: torch.Tensor,
                      vc: torch.Tensor, cache_len: int,
                      cfg: LMConfig) -> torch.Tensor:
    """One layer's attention for one token. Writes the token's K/V row at
    position ``cache_len - 1`` of ``kc`` / ``vc`` in place (the reference's
    ``dynamic_update_slice``): a 27 GB cache cannot be copied every step."""
    B = x.shape[0]
    h = rmsnorm(x, blk.attn_norm)
    pos = cache_len - 1
    positions = torch.full((B, 1), pos, device=x.device)
    q = apply_rope(_proj(h, blk.wq), positions, cfg.rope_theta)
    k_new = apply_rope(_proj(h, blk.wk), positions, cfg.rope_theta)
    v_new = _proj(h, blk.wv)
    kc[:, pos] = k_new[:, 0].to(kc.dtype)
    vc[:, pos] = v_new[:, 0].to(vc.dtype)
    o = decode_attention(q, kc, vc, cache_len, window=cfg.window)
    return _out_proj(o, blk.wo)


def lm_decode_step(model: LM, cache: Dict[str, torch.Tensor],
                   token: torch.Tensor, cache_len: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: ``token`` ``(B, 1)``; ``cache_len`` valid positions
    including the new token's. Returns logits ``(B, vocab)`` float32 and
    ``cache``, updated in place at position ``cache_len - 1``."""
    S = cache["k"].shape[2]
    if not 1 <= cache_len <= S:
        raise ValueError(f"cache_len={cache_len} outside [1, {S}]")
    x = _embed(model, token)
    for i, blk in enumerate(model.layers):
        x = x + _gqa_decode_layer(blk, x, cache["k"][i], cache["v"][i],
                                  cache_len, model.cfg)
        x = x + _ffn_block(blk, x)
    return lm_logits(model, x)[:, 0], cache
