"""GQA attention for the LM (the reference's ``models/lm/attention.py``,
its dense part): the plain online-softmax :func:`chunked_attention`, the
KV-cached :func:`decode_attention`, and :func:`attention`, the route
between the ``flash_attention`` kernel and the plain version.

The MLA functions (DeepSeek-V2) come with that model's slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention

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


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_chunk: int = 512, kv_chunk: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over (q_chunk, kv_chunk) blocks, float32
    scores and accumulators, every KV chunk visited for every q chunk (the
    reference's two scans as Python loops).

    q ``(B, Sq, Hq, D)``; k, v ``(B, Skv, Hkv, Dv)``; ``Hq % Hkv == 0``;
    ``Sq`` and ``Skv`` multiples of their (clipped) chunks. Returns
    ``(B, Sq, Hq, Dv)`` in q's dtype."""
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
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi,
                             k[:, k0:k0 + kv_chunk].float()) * scale
            s = s + _mask(qpos, kpos, causal, window)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p,
                              v[:, k0:k0 + kv_chunk].float())
            o = o * corr[..., None] + pv
            m = m_new
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


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_chunk: int = 512, kv_chunk: int = 1024,
              kernels: str = "kernel") -> torch.Tensor:
    """The prefill's attention: ``kernels="kernel"`` calls the
    ``flash_attention`` kernel wrapper (the kernel on a CUDA tensor, its
    plain version on a CPU tensor); ``"reference"`` calls
    :func:`chunked_attention` (an explicit request, never a fallback)."""
    if kernels == "kernel":
        return flash_attention(q, k, v, causal=causal, window=window)
    if kernels == "reference":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_chunk=q_chunk, kv_chunk=kv_chunk)
    raise ValueError(f"kernels={kernels!r} not in {KERNEL_MODES}")
