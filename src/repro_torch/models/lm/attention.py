"""Attention for the LM (the reference's ``models/lm/attention.py``): the
plain online-softmax :func:`chunked_attention`, the KV-cached
:func:`decode_attention`, :func:`attention`, the route between the
``flash_attention`` kernel and the plain version, and DeepSeek-V2's MLA.
Training attends through :func:`chunked_attention` (the reference's
training path never reaches its Pallas kernel, and the port's kernel is
forward-only).

MLA (:func:`mla_train_attention`, :func:`mla_decode_attention`) follows
the reference: training and prefill materialise each head's K and V from
the ``kv_lora``-wide latent and attend through :func:`chunked_attention`
whatever the kernel route (q/k dim ``qk_nope_dim + qk_rope_dim``, v dim
``v_head_dim``: the reference never reaches its Pallas kernel there, and
the port's kernel wants K and V of one shape); decode uses the absorbed
form, scores straight against the ``(kv_lora + qk_rope_dim)``-wide latent
cache.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.lm.layers import apply_rope, out_proj, proj, rmsnorm
from repro_torch.models.lm.sharding import (
    head_placements, on_shards, seq_dims, write_position,
)

NEG_INF = -1e30
KERNEL_MODES = ("kernel", "reference")


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """(qc, kc) additive float32 mask from absolute positions: 0 where the
    query may see the key, -1e30 elsewhere."""
    m = torch.zeros((qpos.shape[0], kpos.shape[0]), dtype=torch.float32,
                    device=qpos.device)
    if causal:
        m = torch.where(qpos[:, None] >= kpos[None, :], m, NEG_INF)
    if window is not None:
        m = torch.where(qpos[:, None] - kpos[None, :] < window, m, NEG_INF)
    return m


def _kv_step(qi: torch.Tensor, kj: torch.Tensor, vj: torch.Tensor,
             m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
             qpos: torch.Tensor, kpos: torch.Tensor, scale: float,
             causal: bool, window: Optional[int]):
    """One KV chunk of the online softmax: the float32 (q_chunk,
    kv_chunk) score block folded into the running max ``m``, sum ``l``
    and output ``o``."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qi, kj.float()) * scale
    s = s + _mask(qpos, kpos, causal, window)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vj.float())
    return m_new, l_new, o * corr[..., None] + pv


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_chunk: int = 512, kv_chunk: int = 1024,
                      q_offset: int = 0,
                      kv_checkpoint: bool = True) -> torch.Tensor:
    """Online-softmax attention over (q_chunk, kv_chunk) blocks, float32
    scores and accumulators, every KV chunk visited for every q chunk (the
    reference's two scans as Python loops).

    With grad mode on, each KV step runs under a non-reentrant
    ``torch.utils.checkpoint`` (the reference's ``@jax.checkpoint``): the
    backward recomputes each score block instead of keeping all of them
    (at Phi-3's widths, batch 2 and 4,096 tokens, 32 blocks of 168 MB a
    layer). ``kv_checkpoint=False`` keeps them, the plain autograd pass the
    checkpointed one is held against; under ``torch.no_grad()`` neither
    applies and the arithmetic is the same.

    q ``(B, Sq, Hq, D)``; k, v ``(B, Skv, Hkv, Dv)``; ``Hq % Hkv == 0``;
    ``Sq`` and ``Skv`` multiples of their (clipped) chunks. Returns
    ``(B, Sq, Hq, Dv)`` in q's dtype."""
    if isinstance(q, DTensor):
        # each rank attends its batch and head shard, the sequence whole
        pl = head_placements(q, v.shape[2])
        return on_shards(
            lambda q, k, v: chunked_attention(
                q, k, v, causal=causal, window=window, q_chunk=q_chunk,
                kv_chunk=kv_chunk, q_offset=q_offset,
                kv_checkpoint=kv_checkpoint),
            (q, k, v), (pl, pl, pl), pl)
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    G = Hq // Hkv
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    if Sq % q_chunk or Skv % kv_chunk:
        raise ValueError(f"Sq={Sq} / Skv={Skv} are not multiples of "
                         f"q_chunk={q_chunk} / kv_chunk={kv_chunk}")
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    remat = kv_checkpoint and torch.is_grad_enabled()
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qi = q[:, q0:q0 + q_chunk].reshape(B, q_chunk, Hkv, G, D).float()
        qpos = q_offset + q0 + torch.arange(q_chunk, device=dev)
        m = torch.full((B, Hkv, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        o = torch.zeros((B, Hkv, G, q_chunk, Dv), dtype=torch.float32,
                        device=dev)
        for k0 in range(0, Skv, kv_chunk):
            kpos = k0 + torch.arange(kv_chunk, device=dev)
            args = (qi, k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk],
                    m, l, o, qpos, kpos, scale, causal, window)
            # the step draws no random numbers: no RNG state to stash
            m, l, o = (checkpoint(_kv_step, *args, use_reentrant=False,
                                  preserve_rng_state=False)
                       if remat else _kv_step(*args))
        out = o / torch.clamp(l, min=1e-30)[..., None]
        # (B, Hkv, G, qc, Dv) -> (B, qc, Hq, Dv)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, Hq, Dv)
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """One token's attention against a (possibly longer-allocated) KV cache.

    q ``(B, 1, Hq, D)``; caches ``(B, S, Hkv, D)``; ``cache_len`` valid
    positions (the new token's position is ``cache_len - 1``). Scores and
    softmax in float32 over the whole allocated cache, the positions at
    ``cache_len`` and past masked, as the reference does: each layer's
    cache is read as a float32 copy."""
    if isinstance(k_cache, DTensor):
        return _decode_on_shards(q, k_cache, v_cache, cache_len, window)
    B, _, Hq, D = q.shape
    _, S, Hkv, Dv = v_cache.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float()) * scale
    kpos = torch.arange(S, device=q.device)
    qpos = cache_len - 1
    valid = kpos < cache_len
    if window is not None:
        valid &= (qpos - kpos) < window
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return o.reshape(B, 1, Hq, Dv).to(q.dtype)


def _decode_on_shards(q, k_cache, v_cache, cache_len: int, window):
    """:func:`decode_attention` over ``DTensor`` caches, rank by rank: the
    batch split as the caches', and where their sequence is split,
    flash-decoding over those dims (``distributed.collectives``: partial
    softmax statistics a shard, combined by all-reduces)."""
    from repro_torch.distributed.collectives import make_split_kv_decode

    mesh, seq = k_cache.device_mesh, seq_dims(k_cache)
    pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in k_cache.placements)
    if seq:
        fn = make_split_kv_decode(mesh, seq, window)
    else:
        def fn(q, kc, vc, n):
            return decode_attention(q, kc, vc, n, window=window)
    return on_shards(lambda q, kc, vc: fn(q, kc, vc, cache_len),
                     (q, k_cache, v_cache),
                     (pl, k_cache.placements, v_cache.placements), pl)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_chunk: int = 512, kv_chunk: int = 1024,
              kernels: str = "kernel") -> torch.Tensor:
    """The prefill's attention: ``kernels="kernel"`` calls the
    ``flash_attention`` kernel wrapper (the kernel on a CUDA tensor, its
    plain version on a CPU tensor; it refuses inputs that require grad
    under grad mode); ``"reference"`` calls :func:`chunked_attention` (an
    explicit request, never a fallback)."""
    if kernels == "kernel":
        if isinstance(q, DTensor):
            # the kernel's sharding rule: batch and heads (where the KV
            # heads divide), the sequence whole; the plain version on the
            # CPU, rank by rank
            pl = head_placements(q, k.shape[2])
            if not q.is_cuda:
                return on_shards(lambda q, k, v: flash_attention(
                    q, k, v, causal=causal, window=window), (q, k, v),
                    (pl, pl, pl), pl)
            q, k, v = (t.redistribute(t.device_mesh, pl) for t in (q, k, v))
        return flash_attention(q, k, v, causal=causal, window=window)
    if kernels == "reference":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk)
    raise ValueError(f"kernels={kernels!r} not in {KERNEL_MODES}")


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _mla_queries(p, x: torch.Tensor, positions: torch.Tensor, cfg):
    """The low-rank queries: ``w_dq``, ``rmsnorm(q_norm)``, ``w_uq``, split
    into the no-rope ``(..., qk_nope_dim)`` part and the rotated ``(...,
    qk_rope_dim)`` part."""
    cq = rmsnorm(torch.matmul(x, p.w_dq), p.q_norm)
    q = proj(cq, p.w_uq)                                 # (B, S, H, dn + dr)
    qn, qr = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    return qn, apply_rope(qr, positions, cfg.rope_theta)


def _mla_latent(p, x: torch.Tensor, positions: torch.Tensor, cfg):
    """The compressed KV ``rmsnorm(x w_dkv, kv_norm)`` ``(B, S, kv_lora)``
    and the shared rotated key ``x w_kr`` ``(B, S, qk_rope_dim)``."""
    ckv = rmsnorm(torch.matmul(x, p.w_dkv), p.kv_norm)
    kr = apply_rope(torch.matmul(x, p.w_kr)[:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0, :]
    return ckv, kr


def mla_train_attention(p, x: torch.Tensor, positions: torch.Tensor, cfg,
                        q_chunk: int = 512,
                        kv_chunk: int = 1024) -> torch.Tensor:
    """Full-sequence MLA attention, causal. ``p`` holds the MLA leaves as
    attributes (``w_dq, q_norm, w_uq, w_dkv, kv_norm, w_kr, w_uk, w_uv,
    w_o``: an ``LMBlock``); ``x`` ``(B, S, d)``; ``positions`` ``(B, S)``.
    Each head's K (``[ckv w_uk, kr]``) and V (``ckv w_uv``) are
    materialised and attended by :func:`chunked_attention`. Returns ``(B,
    S, d)`` in x's dtype."""
    B, S, _ = x.shape
    H, dr = cfg.n_heads, cfg.qk_rope_dim
    qn, qr = _mla_queries(p, x, positions, cfg)
    ckv, kr = _mla_latent(p, x, positions, cfg)
    kn = proj(ckv, p.w_uk)                               # (B, S, H, dn)
    v = proj(ckv, p.w_uv)                                # (B, S, H, dv)
    qf = torch.cat([qn, qr], dim=-1)
    kf = torch.cat([kn, kr[:, :, None, :].expand(B, S, H, dr)], dim=-1)
    out = chunked_attention(qf, kf, v, causal=True, q_chunk=q_chunk,
                            kv_chunk=kv_chunk)           # (B, S, H, dv)
    return out_proj(out, p.w_o)


def mla_decode_attention(p, x: torch.Tensor, ckv_cache: torch.Tensor,
                         kr_cache: torch.Tensor, cache_len: int,
                         cfg) -> torch.Tensor:
    """One token's MLA attention in the absorbed form: ``q_nope w_uk^T``
    scores the ``(B, S, kv_lora)`` latent cache directly, the rotated query
    the ``(B, S, qk_rope_dim)`` rope-key cache, and the latent-weighted sum
    goes through ``w_uv`` after (the reference's casts: float32 scores and
    softmax over the whole allocated cache, masked at ``cache_len`` and
    past, scale ``1 / sqrt(qk_nope_dim + qk_rope_dim)``, the latent sum cast
    to x's dtype before ``w_uv``). ``x`` ``(B, 1, d)`` (the attention
    norm's output). Writes the token's latent and rope key at position
    ``cache_len - 1`` of the caches in place (the reference's
    ``dynamic_update_slice``) and returns ``(B, 1, d)``."""
    B = x.shape[0]
    pos = cache_len - 1
    positions = torch.full((B, 1), pos, device=x.device)
    qn, qr = _mla_queries(p, x, positions, cfg)
    ckv_new, kr_new = _mla_latent(p, x, positions, cfg)
    write_position(ckv_cache, pos, ckv_new[:, 0])
    write_position(kr_cache, pos, kr_new[:, 0])
    qa = torch.einsum("bshe,che->bshc", qn, p.w_uk)      # (B, 1, H, kv_lora)
    ckv32 = ckv_cache.float()
    s_c = torch.einsum("bshc,btc->bhst", qa.float(), ckv32)
    s_r = torch.einsum("bshe,bte->bhst", qr.float(), kr_cache.float())
    s = (s_c + s_r) * (1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim))
    valid = torch.arange(ckv_cache.shape[1], device=x.device) < cache_len
    attn = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    oc = torch.einsum("bhst,btc->bshc", attn, ckv32)
    o = torch.einsum("bshc,chv->bshv", oc.to(x.dtype), p.w_uv)
    return out_proj(o, p.w_o)
