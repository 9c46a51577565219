"""Synthetic query-traffic generation for embedding serving.

Shared by ``examples/serve_gnn_embeddings.py`` and
``benchmarks/serving_throughput.py`` so the demo and the benchmark measure
the same traffic model.
"""
from __future__ import annotations

import numpy as np


def zipf_batches(rng, n_nodes: int, batch: int, n_batches: int,
                 a: float = 1.1):
    """Skewed lookup traffic: zipf-distributed ranks mapped onto ONE fixed
    random hot-node permutation. The hot set is stable across batches —
    temporal locality a cache can actually exploit — while the hot nodes
    themselves land in arbitrary partitions/blocks (no accidental spatial
    locality from the id layout). Returns a list of ``n_batches`` int64
    arrays of ``batch`` original node ids."""
    hot = rng.permutation(n_nodes)
    return [
        hot[(rng.zipf(a, batch) - 1) % n_nodes] for _ in range(n_batches)
    ]
