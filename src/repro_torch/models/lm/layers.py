"""Transformer building blocks (the reference's ``models/lm/layers.py``):
RMSNorm, RoPE, SwiGLU, the per-head projections and the dense-layer
initialisation."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.lm.sharding import unshard_dims


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis, in float32
    inside, cast back to ``x``'s dtype (over a mesh, the last axis
    gathered first: a partial mean left to DTensor comes back split over
    the sequence)."""
    x = unshard_dims(x, (-1,))
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rope_freqs(d_head: int, theta: float = 10000.0) -> torch.Tensor:
    """The ``d_head / 2`` inverse frequencies, computed in numpy float32 as
    the reference computes them (so the bits are the reference's)."""
    inv = 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))
    return torch.from_numpy(np.ascontiguousarray(inv))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding in the half-split layout (the first half of the
    head's features pairs with the second half, not even with odd).
    ``x`` ``(..., S, H, D)``; ``positions`` broadcastable to ``(..., S)``."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta).to(x.device)
    ang = positions[..., :, None, None].float() * inv   # (..., S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhe->bshe", h, w)`` as one matrix product."""
    d, H, E = w.shape
    w = unshard_dims(w, (2,))
    return torch.matmul(h, w.reshape(d, H * E)).view(*h.shape[:-1], H, E)


def out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshe,hed->bsd", o, wo)`` as one matrix product."""
    H, E, d = wo.shape
    o, wo = unshard_dims(o, (-1,)), unshard_dims(wo, (1,))
    return torch.matmul(o.reshape(*o.shape[:-2], H * E), wo.reshape(H * E, d))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """LLaMA-style gated FFN, ``(silu(x W_gate) * x W_up) W_down``. Weights:
    ``(d, ff)``, ``(d, ff)``, ``(ff, d)``."""
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    return torch.matmul(F.silu(g) * u, w_down)


def init_dense(generator: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None, dtype: torch.dtype = torch.float32,
               device=None) -> torch.Tensor:
    """A ``shape`` tensor of standard normals times ``scale`` (by default
    ``1 / sqrt(shape[0])``, the fan-in), drawn in float32 from
    ``generator`` on ``device`` (the generator's own device by default; the
    two must match) and cast to ``dtype``. The reference draws from a JAX
    key, so the two packages' numbers differ for the same seed; tests hand
    both the same weights instead. The scale is applied in place, so a
    10 M-row table needs no second copy while it is made."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    device = generator.device if device is None else device
    t = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return t.mul_(scale).to(dtype)
