"""Shared dense-layer initialisation (the reference's
``models/lm/layers.py``; the rest of that module comes with the LM port)."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


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
