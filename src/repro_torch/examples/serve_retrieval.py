"""Serving example: batched retrieval against a 1M-candidate corpus — the
port of ``examples/serve_retrieval.py``.

Builds the two-tower model, embeds the candidate corpus through the item
tower in bulk chunks, scores batched user queries against the full
candidate embedding matrix (one matrix product and top-k, the
retrieval_cand shape), and reports latency percentiles.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_retrieval

On the CUDA card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.recsys.two_tower import (
    TwoTower, TwoTowerConfig, init_two_tower, item_embedding,
    score_candidates,
)

N_CAND = 1_000_000    # candidates in the corpus (the retrieval_cand shape)
BULK = 65536          # candidates embedded per item-tower call


def make_config() -> TwoTowerConfig:
    return TwoTowerConfig(
        embed_dim=64, tower_mlp=(128, 64), n_user_fields=4, n_item_fields=2,
        bag_size=4, user_vocab=100_000, item_vocab=100_000,
    )


@torch.no_grad()
def build_corpus(model: TwoTower, cfg: TwoTowerConfig, n_cand: int,
                 rng: np.random.Generator, device, bulk: int = BULK
                 ) -> torch.Tensor:
    """``(n_cand, d)`` candidate embeddings: random item ids from ``rng``,
    through the item tower ``bulk`` candidates at a time (the serve_bulk
    path), kept on ``device``."""
    chunks = []
    for i in range(0, n_cand, bulk):
        ids = rng.integers(0, cfg.item_vocab,
                           (min(bulk, n_cand - i), cfg.n_item_fields,
                            cfg.bag_size)).astype(np.int32)
        chunks.append(item_embedding(model, torch.from_numpy(ids).to(device),
                                     cfg))
    return torch.cat(chunks)


def query_latencies(model: TwoTower, cfg: TwoTowerConfig,
                    corpus: torch.Tensor, rng: np.random.Generator, device,
                    n_queries: int = 30, batch: int = 8, top_k: int = 100
                    ) -> Tuple[List[float], torch.Tensor, torch.Tensor]:
    """Seconds per :func:`score_candidates` call for ``n_queries`` batches
    of ``batch`` random users (each on ``device`` before its clock starts;
    on the card each call ends in a synchronise), and the last call's
    ``(values, indices)``."""
    lat = []
    for _ in range(n_queries):
        u = torch.from_numpy(
            rng.integers(0, cfg.user_vocab,
                         (batch, cfg.n_user_fields, cfg.bag_size)
                         ).astype(np.int32)).to(device)
        if u.is_cuda:
            torch.cuda.synchronize(u.device)
        t0 = time.perf_counter()
        vals, idx = score_candidates(model, u, corpus, cfg, top_k=top_k)
        if u.is_cuda:
            torch.cuda.synchronize(u.device)
        lat.append(time.perf_counter() - t0)
    return lat, vals, idx


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = make_config()
    model = init_two_tower(cfg, torch.Generator(device).manual_seed(0),
                           device)
    rng = np.random.default_rng(0)

    # offline: build candidate corpus embeddings in bulk (serve_bulk shape)
    print(f"building {N_CAND} candidate embeddings (bulk scoring path)...")
    corpus = build_corpus(model, cfg, N_CAND, rng, device)
    print(f"corpus: {tuple(corpus.shape)}")

    # online: p99-style batched queries (serve_p99 / retrieval_cand shapes)
    lat, vals, idx = query_latencies(model, cfg, corpus, rng, device)
    lat = np.array(lat[2:]) * 1e3
    p50, p99 = np.percentile(lat, 50), np.percentile(lat, 99)
    print(f"retrieval over {N_CAND} candidates: p50={p50:.1f}ms "
          f"p99={p99:.1f}ms; top-1 score {float(vals[0, 0]):.3f}")
    return dict(p50_ms=float(p50), p99_ms=float(p99), values=vals,
                indices=idx, corpus=corpus)


if __name__ == "__main__":
    main()
