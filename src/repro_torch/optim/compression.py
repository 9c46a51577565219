"""PowerSGD-style low-rank gradient compression with error feedback (the
reference's ``optim/compression.py``).

Each leaf, reshaped to a matrix (its last axis the columns), is
approximated by a rank-``r`` product ``P Q^T`` from ``power_iters`` power
iterations; what the product leaves out is kept in an error-feedback
accumulator and added to the next step's gradient, so the decompressed
gradients and the final error sum to the true gradients. Small leaves
pass through uncompressed. ``stats`` counts the float32 bytes of the
full and the compressed tree.

The reference seeds each leaf's random start ``Q`` with ``fold_in(key,
i)``; here a ``torch.Generator`` seeded with ``seed`` and the leaf's index
does (the draws cannot equal JAX's), and ``torch.linalg.qr`` takes the
place of ``jnp.linalg.qr``. Trees are ``repro_torch.tree`` trees.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import leaves, plain, rebuild


def _as_matrix(g: torch.Tensor) -> torch.Tensor:
    """A leaf as a matrix: a vector (or a scalar) as one row, else the
    leading axes flattened into rows."""
    if g.dim() <= 1:
        return g.reshape(1, -1)
    return g.reshape(-1, g.shape[-1])


def compress_init(params) -> Dict[str, Any]:
    """Zero float32 error accumulators, one a leaf of ``params``."""
    return {"error": plain(params, lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device))}


def _leaf_seed(seed: int, i: int) -> int:
    """The generator seed of leaf ``i`` (``fold_in(key, i)``'s place)."""
    return (seed * 1_000_003 + i) % (1 << 63)


def compress_decompress(
    grads, state, rank: int = 4, power_iters: int = 1, seed: int = 0,
) -> Tuple[Any, Dict[str, Any], Dict[str, float]]:
    """Returns ``(decompressed_grads, new_state, stats)``.

    A leaf whose matrix has a side of at most ``2 * rank`` or fewer than
    4,096 elements passes through: it comes back as ``g + e`` (cast to
    ``g``'s dtype) with a zero error, and counts its full bytes on both
    sides (compressing it would inflate it). Another leaf comes back as
    ``P Q^T`` and counts ``(rows + cols) * rank`` float32 values."""
    gs = leaves(grads)
    es = [e for _, e in leaves(state["error"])]
    if len(es) != len(gs):
        raise ValueError(f"error state has {len(es)} leaves, the gradients "
                         f"{len(gs)}")
    out, new_err = {}, {}
    bytes_full = 0.0
    bytes_comp = 0.0
    with torch.no_grad():
        for i, ((key, g), e) in enumerate(zip(gs, es)):
            g32 = g.to(torch.float32) + e
            m = _as_matrix(g32)
            r, c = m.shape
            bytes_full += g32.numel() * 4.0
            if min(r, c) <= rank * 2 or g32.numel() < 4096:
                out[key] = g32.to(g.dtype)
                new_err[key] = torch.zeros_like(e)
                bytes_comp += g32.numel() * 4.0
                continue
            gen = torch.Generator(g.device).manual_seed(_leaf_seed(seed, i))
            q = torch.randn((c, rank), generator=gen, dtype=torch.float32,
                            device=g.device)
            for _ in range(power_iters):
                p = m @ q                          # (r, rank)
                p, _ = torch.linalg.qr(p)
                q = m.T @ p                        # (c, rank)
            approx = p @ q.T
            out[key] = approx.reshape(g.shape).to(g.dtype)
            new_err[key] = (m - approx).reshape(g.shape)
            bytes_comp += (r + c) * rank * 4.0
    stats = {
        "ratio": bytes_full / max(bytes_comp, 1.0),
        "bytes_full": bytes_full,
        "bytes_compressed": bytes_comp,
    }
    err_keys = [k for k, _ in leaves(state["error"])]
    new_state = {"error": rebuild(state["error"], dict(zip(
        err_keys, (new_err[k] for k, _ in gs))))}
    return rebuild(grads, out), new_state, stats
