"""Decoder-only transformer (the reference's ``models/lm/transformer.py``):
GQA, sliding-window GQA or MLA attention, a dense SwiGLU or MoE FFN, RoPE;
the prefill forward through the ``flash_attention`` kernel, greedy
KV-cached decode, and training's :func:`lm_loss` with per-layer
rematerialisation.

The reference stacks the layers' parameters along a leading L axis for one
``jax.lax.scan``; here each layer is an :class:`LMBlock` in an
``nn.ModuleList``, so initialising a 14 B-parameter model on the card makes
one layer's float32 temporaries at a time, never an L-stacked one. The
weights keep the reference's einsum layouts (``wq (d, H, Dh)``, ``wo (H,
Dh, d)``, ``w_gate (d, ff)``, an expert's ``w_gate (E, d, ff)``, MLA's
``w_uq (q_lora, H, dn + dr)``, ``lm_head (d, V)``, ...) and leaf names,
so converting between the two is a stack or an unstack
(``repro_torch.params``). An MoE config's first ``first_dense`` layers
(DeepSeek-V2's dense first layer) are :attr:`LM.dense_layers`, apart from
the rest, as the reference's ``params["dense_layers"]`` are apart from its
scanned ``params["layers"]``.

The parameters do not require gradients, so serving builds no autograd
graph whatever the grad mode. Training asks for them:
:func:`lm_value_and_grad` switches ``requires_grad`` on for the one
gradient it takes and off again. Training attends through the plain
``chunked_attention`` (the reference's training path; the
``flash_attention`` kernel is forward-only) and, with ``LMConfig.remat``,
runs each layer under a non-reentrant ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of its scan body). MLA attends through
``chunked_attention`` in every mode, as the reference's does.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm.attention import (
    attention, decode_attention, mla_decode_attention, mla_train_attention,
)
from repro_torch.models.lm.layers import (
    apply_rope, init_dense, out_proj, proj, rmsnorm,
)
from repro_torch.models.lm.moe import MoEConfig, moe_ffn, moe_param_shapes
from repro_torch.models.lm.sharding import (
    DB, constrain, on_shards, rows_of, write_position,
)

ATTN_TYPES = ("gqa", "mla")


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
    attn_type: str = "gqa"          # "gqa" | "mla"
    window: Optional[int] = None    # sliding-window attention (Mixtral)
    moe: Optional[MoEConfig] = None
    rope_theta: float = 1e4
    # MLA dims (DeepSeek-V2)
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
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
        if self.attn_type not in ATTN_TYPES:
            raise ValueError(f"attn_type={self.attn_type!r} not in "
                             f"{ATTN_TYPES}")
        if self.moe is not None and not isinstance(self.moe, MoEConfig):
            raise TypeError(f"moe={self.moe!r} is not a MoEConfig")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads={self.n_heads} is not a multiple of "
                             f"n_kv_heads={self.n_kv_heads}")

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape (sliding window => O(S * W))."""
        return self.window is not None

    @property
    def n_dense(self) -> int:
        """The leading layers with a dense FFN of an MoE config
        (``moe.first_dense``); 0 without MoE."""
        return self.moe.first_dense if self.moe is not None else 0

    def param_count(self) -> int:
        """The reference's count: the embedding and head, two norms a
        layer, the attention's matrices and the FFN's, every layer counted
        as an MoE layer when ``moe`` is set (so a ``first_dense`` layer
        counts as one, not at ``d_ff_dense``) and MLA's ``q_norm`` /
        ``kv_norm`` left out; the final norm is left out too. The model's
        real leaves are :func:`count_params`'."""
        d = self.d_model
        per = 2 * d                                             # norms
        if self.attn_type == "gqa":
            per += d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head
            per += self.n_heads * self.d_head * d
        else:
            dn, dr, dv = self.qk_nope_dim, self.qk_rope_dim, self.v_head_dim
            per += d * self.q_lora + self.q_lora * self.n_heads * (dn + dr)
            per += d * (self.kv_lora + dr)
            per += self.kv_lora * self.n_heads * (dn + dv)
            per += self.n_heads * dv * d
        if self.moe is None:
            per += 3 * d * self.d_ff
        else:
            m = self.moe
            per += m.n_experts * 3 * d * m.d_ff_expert
            per += 3 * d * m.d_ff_shared_total
            per += d * m.n_experts
        return self.vocab * d * 2 + per * self.n_layers         # + embed, head

    def active_param_count(self) -> int:
        if self.moe is None:
            return self.param_count()
        m = self.moe
        inactive = (m.n_experts - m.top_k) * 3 * self.d_model * m.d_ff_expert
        return self.param_count() - inactive * self.n_layers


def _attn_shapes(cfg: LMConfig) -> Dict[str, tuple]:
    """One layer's attention leaves and their shapes, the reference's
    names (norm vectors included)."""
    d, H = cfg.d_model, cfg.n_heads
    if cfg.attn_type == "gqa":
        Hkv, Dh = cfg.n_kv_heads, cfg.d_head
        return {"wq": (d, H, Dh), "wk": (d, Hkv, Dh), "wv": (d, Hkv, Dh),
                "wo": (H, Dh, d)}
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {"w_dq": (d, cfg.q_lora), "q_norm": (cfg.q_lora,),
            "w_uq": (cfg.q_lora, H, dn + dr), "w_dkv": (d, cfg.kv_lora),
            "kv_norm": (cfg.kv_lora,), "w_kr": (d, dr),
            "w_uk": (cfg.kv_lora, H, dn), "w_uv": (cfg.kv_lora, H, dv),
            "w_o": (H, dv, d)}


def _ffn_shapes(cfg: LMConfig, dense_ff: Optional[int]) -> Dict[str, tuple]:
    """One layer's FFN leaves: the MoE's (:func:`moe_param_shapes`) unless
    ``dense_ff`` or the config is dense."""
    if cfg.moe is not None and dense_ff is None:
        return moe_param_shapes(cfg.d_model, cfg.moe)
    ff, d = dense_ff or cfg.d_ff, cfg.d_model
    return {"w_gate": (d, ff), "w_up": (d, ff), "w_down": (ff, d)}


# the leaves made as ones (norms), and the one kept in float32
NORM_LEAVES = ("attn_norm", "ffn_norm", "q_norm", "kv_norm")
FLOAT32_LEAVES = ("router",)


class LMBlock(nn.Module):
    """One layer's parameters, in the reference's layouts and leaf names:
    ``attn_norm``, ``ffn_norm``, the attention's (GQA ``wq, wk, wv, wo``
    or MLA ``w_dq, q_norm, w_uq, w_dkv, kv_norm, w_kr, w_uk, w_uv,
    w_o``), the FFN's (dense ``w_gate, w_up, w_down``, or MoE ``router``,
    the experts' ``w_gate, w_up, w_down`` and ``shared_*``). ``dense_ff``
    makes an MoE config's layer dense at that width (a ``first_dense``
    layer)."""

    def __init__(self, cfg: LMConfig, device,
                 dense_ff: Optional[int] = None):
        super().__init__()
        self.is_moe = cfg.moe is not None and dense_ff is None
        shapes = {"attn_norm": (cfg.d_model,), "ffn_norm": (cfg.d_model,),
                  **_attn_shapes(cfg), **_ffn_shapes(cfg, dense_ff)}
        for name, shape in shapes.items():
            dtype = torch.float32 if name in FLOAT32_LEAVES else cfg.dtype
            make = torch.ones if name in NORM_LEAVES else torch.empty
            setattr(self, name, nn.Parameter(
                make(shape, dtype=dtype, device=device), requires_grad=False))


class LM(nn.Module):
    """The model's parameters on ``device`` (the CUDA card unless
    ``device="cpu"``), uninitialised except the norms (ones): fill them
    with :func:`init_lm_params` or ``repro_torch.params.lm_from_jax``.
    ``dense_layers`` holds an MoE config's first ``first_dense`` layers
    (dense FFNs of ``d_ff_dense``), ``layers`` the rest; a dense config
    has no dense layers apart."""

    def __init__(self, cfg: LMConfig, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        nd = cfg.n_dense
        dff = (cfg.moe.d_ff_dense or cfg.d_ff) if nd else None
        self.embed = _param((cfg.vocab, cfg.d_model), cfg, device)
        self.dense_layers = nn.ModuleList(
            LMBlock(cfg, device, dense_ff=dff) for _ in range(nd))
        self.layers = nn.ModuleList(LMBlock(cfg, device)
                                    for _ in range(cfg.n_layers - nd))
        self.final_norm = nn.Parameter(
            torch.ones(cfg.d_model, dtype=cfg.dtype, device=device),
            requires_grad=False)
        self.lm_head = _param((cfg.d_model, cfg.vocab), cfg, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def blocks(self):
        """Every layer in order: the dense ones, then the rest."""
        return [*self.dense_layers, *self.layers]


def _param(shape, cfg: LMConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device),
                        requires_grad=False)


def count_params(cfg: LMConfig) -> int:
    """The elements of the model's real leaves (final norm, MLA's norms
    and a ``first_dense`` layer's dense FFN included), without making
    it."""
    return sum(p.numel() for p in LM(cfg, device="meta").parameters())


# the leaves drawn at another scale than init_dense's 1 / sqrt(shape[0])
def _scale(name: str, cfg: LMConfig) -> Optional[float]:
    if name == "wo":
        return 1.0 / (cfg.n_heads * cfg.d_head) ** 0.5
    if name == "w_o":
        return 1.0 / (cfg.n_heads * cfg.v_head_dim) ** 0.5
    if name == "router":
        return 0.02
    return None


def init_lm_params(cfg: LMConfig, generator: torch.Generator,
                   device: DeviceLike = None) -> LM:
    """An :class:`LM` on ``device`` with the reference's initialisation
    (``init_dense``: normals times ``1 / sqrt(shape[0])``, so an expert
    weight's fan-in is the expert count, as the reference's; the
    embedding and the router times 0.02; ``wo`` / ``w_o`` times ``1 /
    sqrt(H * head dim)``; norms ones), drawn from ``generator``, which must
    lie on ``device``: embedding, head, then each layer's leaves in
    :class:`LMBlock` order (the dense layers first). One tensor's float32
    draw at a time."""
    model = LM(cfg, device)
    dev = model.device

    def fill(p: nn.Parameter, scale: Optional[float] = None) -> None:
        p.copy_(init_dense(generator, p.shape, scale=scale,
                           dtype=p.dtype, device=dev))

    with torch.no_grad():
        fill(model.embed, 0.02)
        fill(model.lm_head)
        for blk in model.blocks():
            for name, p in blk.named_parameters():
                if name not in NORM_LEAVES:
                    fill(p, _scale(name, cfg))
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _attn_block(blk: LMBlock, x: torch.Tensor, positions: torch.Tensor,
                cfg: LMConfig, kernels: str) -> torch.Tensor:
    h = rmsnorm(x, blk.attn_norm)
    if cfg.attn_type == "mla":
        return mla_train_attention(blk, h, positions, cfg,
                                   q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    q = constrain(proj(h, blk.wq), DB, None, "model")
    k = constrain(proj(h, blk.wk), DB, None, "model")
    v = constrain(proj(h, blk.wv), DB, None, "model")
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=True, window=cfg.window,
                  q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk, kernels=kernels)
    return constrain(out_proj(o, blk.wo), DB, None, None)


def _ffn_block(blk: LMBlock, x: torch.Tensor, cfg: LMConfig
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The FFN's output and, for an MoE layer, its aux loss (None for a
    dense one)."""
    h = rmsnorm(x, blk.ffn_norm)
    if blk.is_moe:
        y, aux = moe_ffn(blk, h.reshape(-1, h.shape[-1]), cfg.moe)
        y = rows_of(y, h.shape[0])      # a mesh's split of the tokens
        return constrain(y.view(h.shape), DB, None, None), aux
    # swiglu's products, each pinned as the reference pins them
    g = constrain(torch.matmul(h, blk.w_gate), DB, None, "model")
    u = constrain(torch.matmul(h, blk.w_up), DB, None, "model")
    y = torch.matmul(F.silu(g) * u, blk.w_down)
    return constrain(y, DB, None, None), None


def _layer_fwd(blk: LMBlock, x: torch.Tensor, positions: torch.Tensor,
               cfg: LMConfig, kernels: str
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    x = constrain(x, DB, None, None)
    x = x + _attn_block(blk, x, positions, cfg, kernels)
    y, aux = _ffn_block(blk, x, cfg)
    return constrain(x + y, DB, None, None), aux


def _embed(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    if tokens.device != model.device:
        raise ValueError(f"tokens are on {tokens.device}, the model on "
                         f"{model.device}")

    def lookup(embed, tokens):
        return embed[tokens.long()].to(model.cfg.dtype)

    if not isinstance(model.embed, DTensor):
        return lookup(model.embed, tokens)
    # over a mesh, ZeRO-3: the table gathered, each rank looks up its
    # batch split, and the table's gradient is a partial sum
    split = [isinstance(p, Shard) and p.dim == 0 for p in tokens.placements]
    tok = tuple(Shard(0) if s else Replicate() for s in split)
    rep = tuple(Replicate() for _ in split)
    part = tuple(Partial() if s else Replicate() for s in split)
    return on_shards(lookup, (model.embed, tokens), (rep, tok), tok,
                     (part, tok))


def _lm_body(model: LM, tokens: torch.Tensor, kernels: str
             ) -> Tuple[torch.Tensor, Any]:
    """The residual stream after the last layer and the MoE layers' summed
    aux loss (a float32 0-d tensor; 0.0 for a dense config)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = _embed(model, tokens)
    remat = model.cfg.remat and torch.is_grad_enabled()
    auxs = []
    for blk in model.blocks():
        if remat:
            # the layer draws no random numbers: no RNG state to stash
            x, aux = checkpoint(_layer_fwd, blk, x, positions, model.cfg,
                                kernels, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = _layer_fwd(blk, x, positions, model.cfg, kernels)
        if aux is not None:
            auxs.append(aux)
    return x, (torch.stack(auxs).sum() if auxs else 0.0)


def lm_hidden(model: LM, tokens: torch.Tensor,
              kernels: str = "kernel") -> torch.Tensor:
    """tokens ``(B, S)`` -> the residual stream after the last layer,
    ``(B, S, d_model)`` in the model's dtype (before the final norm). With
    ``cfg.remat`` and grad mode on, each layer runs under a checkpoint: the
    backward keeps only each layer's input and recomputes the rest."""
    return _lm_body(model, tokens, kernels)[0]


def lm_logits(model: LM, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the head, in float32: ``(..., d)`` -> ``(..., V)``.
    Both act row by row, so they may be given any subset of positions."""
    x = rmsnorm(x, model.final_norm)
    logits = torch.matmul(x.float(), model.lm_head.float())
    return constrain(logits, DB, *([None] * (logits.dim() - 2)), "model")


def lm_forward(model: LM, tokens: torch.Tensor,
               kernels: str = "kernel") -> Tuple[torch.Tensor, Any]:
    """tokens ``(B, S)`` -> logits ``(B, S, vocab)`` float32, and the MoE
    auxiliary loss summed over the MoE layers (a float32 0-d tensor; 0.0
    when every FFN is dense). ``kernels`` routes the GQA attention
    (:func:`~repro_torch.models.lm.attention.attention`); MLA attends
    through ``chunked_attention`` in both modes."""
    x, aux = _lm_body(model, tokens, kernels)
    return lm_logits(model, x), aux


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

    def nll(logits, tgt):
        lp = F.log_softmax(logits[:, :-1], dim=-1)
        ll = torch.gather(lp, -1, tgt[..., None])
        return -ll.mean()

    if isinstance(tgt, DTensor):
        # over a mesh, rank by rank over its batch split (the vocabulary
        # whole), the mean the ranks' means: DTensor's gather would make
        # its gradient at the global shape on every rank
        split = [isinstance(p, Shard) and p.dim == 0 for p in tgt.placements]
        pl = tuple(Shard(0) if s else Replicate() for s in split)
        avg = [Partial("avg") if s else Replicate() for s in split]
        loss = on_shards(nll, (logits, tgt), (pl, pl), avg)
    else:
        loss = nll(logits, tgt)
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
    ``(loss, (ce, aux))`` detached (aux 0.0 for a dense config) and
    ``{parameter name: gradient}`` in ``named_parameters`` order, each in
    its parameter's dtype. Grad mode is on inside, whatever the
    caller's."""
    names = [n for n, _ in model.named_parameters()]
    with torch.enable_grad(), _requiring_grad(model) as params:
        loss, (ce, aux) = lm_loss(model, tokens, aux_weight)
        grads = torch.autograd.grad(loss, params)
    if isinstance(aux, torch.Tensor):
        aux = aux.detach()
    return (loss.detach(), (ce.detach(), aux)), dict(zip(names, grads))


# ---------------------------------------------------------------------------
# decode (KV-cached)
# ---------------------------------------------------------------------------

def _cache_leaves(cfg: LMConfig) -> Dict[str, tuple]:
    """A layer's cache entries and their per-position shapes: GQA's K and V
    ``(Hkv, Dh)``, MLA's latent ``(kv_lora,)`` and rope key
    ``(qk_rope_dim,)``."""
    if cfg.attn_type == "mla":
        return {"ckv": (cfg.kv_lora,), "kr": (cfg.qk_rope_dim,)}
    kv = (cfg.n_kv_heads, cfg.d_head)
    return {"k": kv, "v": kv}


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int,
                  dtype: Optional[torch.dtype] = None,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Zeroed caches in ``dtype`` (the model's by default) on ``device``
    (the CUDA card unless ``device="cpu"``), each ``(n_layers, batch,
    max_len, ...)`` in :meth:`LM.blocks` order (the first ``first_dense``
    layers are the reference's ``cache["dense"]``, the rest its
    ``cache["scan"]``): GQA's ``{"k", "v"}`` ``(..., Hkv, Dh)``, MLA's
    ``{"ckv", "kr"}`` ``(..., kv_lora)`` / ``(..., qk_rope_dim)``."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    return {name: torch.zeros((cfg.n_layers, batch, max_len) + tail,
                              dtype=dtype, device=device)
            for name, tail in _cache_leaves(cfg).items()}


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
    q = apply_rope(proj(h, blk.wq), positions, cfg.rope_theta)
    k_new = apply_rope(proj(h, blk.wk), positions, cfg.rope_theta)
    v_new = proj(h, blk.wv)
    write_position(kc, pos, k_new[:, 0])
    write_position(vc, pos, v_new[:, 0])
    o = decode_attention(q, kc, vc, cache_len, window=cfg.window)
    return out_proj(o, blk.wo)


def _decode_attn(blk: LMBlock, x: torch.Tensor, cache: Dict, i: int,
                 cache_len: int, cfg: LMConfig) -> torch.Tensor:
    if cfg.attn_type == "mla":
        return mla_decode_attention(
            blk, rmsnorm(x, blk.attn_norm), cache["ckv"][i], cache["kr"][i],
            cache_len, cfg)
    return _gqa_decode_layer(blk, x, cache["k"][i], cache["v"][i],
                             cache_len, cfg)


def lm_decode_step(model: LM, cache: Dict[str, torch.Tensor],
                   token: torch.Tensor, cache_len: int
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: ``token`` ``(B, 1)``; ``cache_len`` valid positions
    including the new token's. The dense layers run first, then the rest,
    each with its FFN (dense or MoE) and its attention (GQA, windowed GQA
    or MLA's absorbed form). Returns logits ``(B, vocab)`` float32 and
    ``cache`` (:func:`init_kv_cache`'s), updated in place at position
    ``cache_len - 1``."""
    S = next(iter(cache.values())).shape[2]
    if not 1 <= cache_len <= S:
        raise ValueError(f"cache_len={cache_len} outside [1, {S}]")
    cfg = model.cfg
    x = _embed(model, token)
    for i, blk in enumerate(model.blocks()):
        x = x + _decode_attn(blk, x, cache, i, cache_len, cfg)
        x = x + _ffn_block(blk, x, cfg)[0]
    return lm_logits(model, x)[:, 0], cache
