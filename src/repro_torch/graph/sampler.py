"""Fanout neighbor sampler (GraphSAGE-style) producing message-flow graphs.

The port of the reference's ``graph/sampler.py``, numpy only: for the same
graph, fanouts and seed it draws the same neighbours and emits the same
MFGs, bit for bit. It serves sampled mini-batch training (the
``minibatch_lg`` shape: batch_nodes=1024, fanout=15-10); the micro-batch
baseline (``core/microbatch.py``) does not sample and builds its
full-neighbourhood MFGs itself. MFGs have **static padded shapes**: per
hop, ``n_dst * fanout`` edge slots, padded with a sentinel self-edge of
weight 0.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.graph.csr import CSRGraph


@dataclasses.dataclass
class MFGLayer:
    """One bipartite hop: messages flow src_ids -> dst_ids.

    ``src_index``/``dst_index`` index into this hop's *local* node array
    (``node_ids``); dst nodes occupy the first ``n_dst`` slots (self-inclusive
    ordering, as in DGL blocks).
    """

    node_ids: np.ndarray     # int64 (n_src_total,) global ids; first n_dst = dst
    n_dst: int
    src_index: np.ndarray    # int32 (n_edges_padded,) local src slot per edge
    dst_index: np.ndarray    # int32 (n_edges_padded,) local dst slot per edge
    edge_mask: np.ndarray    # float32 (n_edges_padded,) 1=real, 0=pad


@dataclasses.dataclass
class MessageFlowGraph:
    layers: List[MFGLayer]   # layers[0] is the innermost hop (input features)
    seeds: np.ndarray        # int64 (batch,) output/seed vertex ids

    @property
    def n_input_nodes(self) -> int:
        return int(self.layers[0].node_ids.shape[0])


class NeighborSampler:
    def __init__(self, g: CSRGraph, fanouts: Sequence[int], seed: int = 0):
        self.g = g
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)

    def _sample_hop(self, dst_ids: np.ndarray, fanout: int) -> MFGLayer:
        g = self.g
        n_dst = dst_ids.shape[0]
        deg = (g.indptr[dst_ids + 1] - g.indptr[dst_ids]).astype(np.int64)
        # sample `fanout` neighbors with replacement for vertices with deg>0
        offs = self.rng.integers(0, np.maximum(deg, 1)[:, None], (n_dst, fanout))
        pos = g.indptr[dst_ids][:, None] + offs
        nbr = g.indices[pos].astype(np.int64)        # (n_dst, fanout)
        valid = (deg > 0)[:, None] & np.ones((1, fanout), dtype=bool)
        # local node array: dst first, then unique new sources
        flat_nbr = nbr[valid]
        uniq = np.unique(flat_nbr)
        extra = uniq[~np.isin(uniq, dst_ids, assume_unique=False)]
        node_ids = np.concatenate([dst_ids, extra])
        lut = {int(v): i for i, v in enumerate(node_ids)}
        src_local = np.fromiter(
            (lut[int(v)] for v in nbr.ravel()), dtype=np.int32, count=nbr.size
        )
        dst_local = np.repeat(
            np.arange(n_dst, dtype=np.int32), fanout
        )
        mask = valid.ravel().astype(np.float32)
        # masked-out edges point at dst itself (harmless with weight 0)
        src_local = np.where(mask > 0, src_local, dst_local)
        return MFGLayer(
            node_ids=node_ids,
            n_dst=n_dst,
            src_index=src_local,
            dst_index=dst_local,
            edge_mask=mask,
        )

    def sample(self, seeds: np.ndarray) -> MessageFlowGraph:
        """Sample an L-hop MFG rooted at ``seeds`` (outermost hop last)."""
        seeds = np.asarray(seeds, dtype=np.int64)
        layers: List[MFGLayer] = []
        dst = seeds
        for fanout in self.fanouts:            # outermost -> innermost
            hop = self._sample_hop(dst, fanout)
            layers.append(hop)
            dst = hop.node_ids
        layers.reverse()                       # innermost first
        return MessageFlowGraph(layers=layers, seeds=seeds)
