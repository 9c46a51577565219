"""Workload shapes and model FLOP counts (the part of the reference's
``configs/base.py`` that the ported paths use)."""
from __future__ import annotations

from typing import Any, Dict

RECSYS_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}


def recsys_model_flops(cfg, kind: str, batch: int, n_candidates: int = 0) -> float:
    """Matrix-product FLOPs of one two-tower call: the towers' MLPs (times 3
    in training: forward and two backward products) and, in training, the
    in-batch logits; in retrieval the candidate scores. The bag sums are
    not counted (they are memory-bound)."""
    dims_u = [cfg.n_user_fields * cfg.embed_dim] + list(cfg.tower_mlp)
    dims_i = [cfg.n_item_fields * cfg.embed_dim] + list(cfg.tower_mlp)
    mlp_u = sum(2 * a * b for a, b in zip(dims_u[:-1], dims_u[1:]))
    mlp_i = sum(2 * a * b for a, b in zip(dims_i[:-1], dims_i[1:]))
    if kind == "train":
        return 3.0 * batch * (mlp_u + mlp_i) + 3.0 * 2 * batch * batch * cfg.tower_mlp[-1]
    if kind == "serve":
        return batch * mlp_u
    return batch * mlp_u + 2.0 * batch * n_candidates * cfg.tower_mlp[-1]
