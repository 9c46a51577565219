"""Hand-written collectives: split-KV flash-decoding over
``torch.distributed`` (the reference's ``distributed/collectives.py``).

For long-context decode the KV cache shards across the mesh on the sequence
dim. Each rank computes partial online-softmax statistics ``(m, l, o)``
over its KV slice; the exact global softmax comes back from a MAX
all-reduce of ``m`` and SUM all-reduces of ``l * corr`` and ``o * corr``
(``corr = exp(m - m_global)``) — flash-decoding over the ranks instead of
gathering the whole cache on each.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

NEG = -1e30


def _partial_attention(q, k, v, kpos, cache_len: int, window):
    """Partial ``(m, l, o)`` over a KV shard. q ``(B, Hkv, G, D)``; k / v
    ``(B, S_local, Hkv, D)``; ``kpos`` the shard's global positions."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k.float()) * scale
    qpos = cache_len - 1
    valid = kpos < cache_len
    if window is not None:
        valid &= (qpos - kpos) < window
    s = torch.where(valid, s, NEG)
    m = s.amax(dim=-1)                                   # (B, Hkv, G)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return m, l, o


def make_split_kv_decode(
    mesh, seq_axes: Sequence[str] = ("model",), window: Optional[int] = None,
):
    """Returns ``decode_attn(q (B, 1, Hq, D), k_cache, v_cache, cache_len)``
    where each rank holds its slice ``(B, S_local, Hkv, D)`` of caches
    sequence-sharded over the mesh dims ``seq_axes`` (rank order, the
    first dim major). Every rank returns the whole ``(B, 1, Hq, D)``
    output."""
    names = list(mesh.mesh_dim_names)
    groups = [mesh.get_group(a) for a in seq_axes]

    def decode_attn(q, kc, vc, cache_len: int):
        B, _, Hq, D = q.shape
        _, S_local, Hkv, _ = kc.shape
        qg = q.reshape(B, Hkv, Hq // Hkv, D)
        # this rank's position along the sequence-sharded dims
        idx = 0
        for a in seq_axes:
            idx = idx * mesh.size(names.index(a)) + mesh.get_local_rank(a)
        kpos = idx * S_local + torch.arange(S_local, device=q.device)
        m, l, o = _partial_attention(qg, kc, vc, kpos, cache_len, window)
        # exact combine: global max, rescale, sum (dim by dim)
        m_g = m.clone()
        for g in groups:
            dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=g)
        corr = torch.exp(m - m_g)
        lo = torch.cat([(l * corr).reshape(-1),
                        (o * corr[..., None]).reshape(-1)])
        for g in groups:
            dist.all_reduce(lo, group=g)
        l_g = lo[:l.numel()].view_as(l)
        o_g = lo[l.numel():].view_as(o)
        out = o_g / torch.clamp_min(l_g, 1e-30)[..., None]
        return out.reshape(B, 1, Hq, -1).to(q.dtype)

    return decode_attn


def decode_attention_ref(q, k, v, cache_len: int, window=None):
    """Unsharded oracle: the port's ``decode_attention``."""
    from repro_torch.models.lm.attention import decode_attention

    return decode_attention(q, k, v, cache_len, window=window)
