"""Plain versions of the flash-attention kernel.

- :func:`attention_ref` is the reference package's materialised oracle
  (``src/repro/kernels/flash_attention/ref.py:9``): float32 scores of every
  (q, k) pair, masked to -1e30, a softmax, and the product with v, cast to
  the input dtype.
- :func:`attention_np` is a float64 numpy oracle of the same function.
- :func:`flash_attention_ref` is the plain version the kernel is held to.
  It does the TPU kernel's arithmetic (``flash_attention.py:39-58``): a
  loop over KV blocks of 128 keys with all queries at once, float32 scores
  ``(q . k) * (1 / sqrt(D))``, the masks ``qpos >= kpos`` (causal) and
  ``qpos - kpos < window`` with both positions from 0, float32 ``m`` (from
  -1e30), ``l`` and ``acc``, and ``acc / max(l, 1e-30)`` cast to the input
  dtype. The last block may be short (any ``Skv``). It keeps one block of
  scores, ``(B, Hq, Sq, 128)`` float32, never an ``Sq x Skv`` buffer.

Layouts are the reference's: q ``(B, Sq, Hq, D)``, k and v ``(B, Skv, Hkv,
D)``, ``Hq % Hkv == 0``, query head ``h`` reading KV head ``h // (Hq //
Hkv)``. All three return the mean of v for a row with no unmasked key (each
masked score is -1e30, so each ``p`` is 1), as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

NEG = -1e30
KV_BLOCK = 128


def _mask(Sq: int, k0: int, k1: int, causal: bool, window: Optional[int],
          device) -> Optional[torch.Tensor]:
    """(Sq, k1 - k0) bool: True where query ``i`` may see key ``k0 + j``;
    None where every pair may."""
    if not causal and window is None:
        return None
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    keep = torch.ones((Sq, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= (qpos - kpos) < window
    return keep


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """Materialised attention: (B, Sq, Hq, D) -> (B, Sq, Hq, Dv)."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) / math.sqrt(D)
    keep = _mask(Sq, 0, Skv, causal, window, q.device)
    if keep is not None:
        s = torch.where(keep, s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, Hq, Dv).to(q.dtype)


def attention_np(q, k, v, causal: bool = True,
                 window: Optional[int] = None) -> np.ndarray:
    """Float64 numpy oracle of :func:`attention_ref` (inputs as numpy
    arrays of any float dtype; output float64)."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    G = Hq // Hkv
    s = np.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, Hkv, G, D), k)
    s /= np.sqrt(D)
    qpos = np.arange(Sq)[:, None]
    kpos = np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), bool)
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= (qpos - kpos) < window
    s = np.where(keep, s, NEG)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    o = np.einsum("bhgqk,bkhd->bqhgd", p, v)
    return o.reshape(B, Sq, Hq, Dv)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        kv_block: int = KV_BLOCK) -> torch.Tensor:
    """The TPU kernel's online softmax over KV blocks of ``kv_block`` keys,
    all queries at once: (B, Sq, Hq, D) -> (B, Sq, Hq, Dv) in q's dtype."""
    B, Sq, Hq, D = q.shape
    _, Skv, Hkv, Dv = v.shape
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(D)
    # (B, Hkv, G * Sq, D): each KV head's query rows, group by group
    qf = q.float().reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4).reshape(
        B, Hkv, G * Sq, D)
    m = torch.full((B, Hkv, G, Sq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, Sq, Dv), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, Skv, kv_block):
        k1 = min(k0 + kv_block, Skv)
        kb = k[:, k0:k1].float().permute(0, 2, 3, 1)        # (B, Hkv, D, n)
        vb = v[:, k0:k1].float().permute(0, 2, 1, 3)        # (B, Hkv, n, Dv)
        s = torch.matmul(qf, kb).view(B, Hkv, G, Sq, k1 - k0).mul_(scale)
        keep = _mask(Sq, k0, k1, causal, window, q.device)
        if keep is not None:
            s.masked_fill_(~keep, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = s.sub_(m_new[..., None]).exp_()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.matmul(p.view(B, Hkv, G * Sq, k1 - k0), vb)
        acc = acc.mul_(corr[..., None]).add_(pv.view(B, Hkv, G, Sq, Dv))
        m = m_new
        del s, p, pv
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dv).to(q.dtype)


# the absolute floor of the bf16 comparison with the plain version: near 0 a
# bf16 ulp is finer than the float32 sums' own rounding differences
BF16_ABS_FLOOR = 1e-6


def within_one_bf16_ulp(got: torch.Tensor, plain: torch.Tensor) -> bool:
    """Every element of ``got`` within 1 bf16 ulp of ``plain``, or within
    :data:`BF16_ABS_FLOOR` of it (both bf16)."""
    near = (got.float() - plain.float()).abs() <= BF16_ABS_FLOOR
    return bool(((bf16_ulp_distance(got, plain) <= 1) | near).all())


def bf16_ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """How many bf16 values lie between ``a`` and ``b`` (bf16 tensors of one
    shape), elementwise, as int32: 0 where they are equal (+0 and -0
    count as equal), 1 for neighbours."""
    def ordered(t):
        u = t.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
        mag = u & 0x7FFF
        return torch.where(u >= 0x8000, -mag, mag)

    return (ordered(a) - ordered(b)).abs()
