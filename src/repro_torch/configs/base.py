"""Workload shapes and model FLOP counts (the part of the reference's
``configs/base.py`` that the ported paths use: the recsys and LM shapes,
their FLOP counts and the LM's closed-form attention term)."""
from __future__ import annotations

from typing import Any, Dict

LM_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

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


def lm_model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """Model FLOPs of one LM call: 6 (train) or 2 (prefill) per active
    parameter and token; a decode step is 2 per active parameter and
    sequence plus the attention over the ``seq``-long cache (``2 * 2 *
    layers * batch * seq * heads * d_head``, times ``window / seq`` for a
    sliding window). Prefill's attention is not in it: see
    :func:`lm_attention_correction`."""
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * batch * seq
    if kind == "prefill":
        return 2.0 * n_active * batch * seq
    attn = (
        2.0 * 2.0 * cfg.n_layers * batch * seq
        * cfg.n_heads * cfg.d_head
    )
    if cfg.window is not None:
        attn *= min(cfg.window / seq, 1.0)
    return 2.0 * n_active * batch + attn


def lm_attention_correction(cfg, kind: str, batch: int, seq: int):
    """Closed-form attention FLOPs and bytes of a train or prefill call
    (causal, or a sliding window): ``pairs`` (q, k) pairs per head, each
    ``2 * d_qk + 2 * d_v`` FLOPs, times 4 in training (forward, recomputed
    forward, two backward products); bytes with K/V streamed once per
    ``q_chunk`` block and q/out read and written once. Decode: zero."""
    if kind == "decode":
        return dict(flops=0.0, bytes=0.0)
    S, B = seq, batch
    W = cfg.window
    if W is not None and S > W:
        pairs = W * S - W * W / 2.0
    else:
        pairs = S * (S + 1) / 2.0
    if cfg.attn_type == "mla":
        d_qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        d_v = cfg.v_head_dim
        h_kv = cfg.n_heads
    else:
        d_qk = d_v = cfg.d_head
        h_kv = cfg.n_kv_heads
    fwd_flops = B * cfg.n_heads * pairs * (2.0 * d_qk + 2.0 * d_v)
    mult = 4.0 if kind == "train" else 1.0
    flops = mult * cfg.n_layers * fwd_flops
    nq = max(S // cfg.q_chunk, 1)
    kv_bytes = nq * B * h_kv * S * (d_qk + d_v) * 2.0
    qo_bytes = 3.0 * B * cfg.n_heads * S * (d_qk + d_v) * 2.0
    bmult = 3.0 if kind == "train" else 1.0
    nbytes = bmult * cfg.n_layers * (kv_bytes + qo_bytes)
    return dict(flops=flops, bytes=nbytes)
