"""The row plan of the kernels that walk a destination-sorted edge list
(``gather_aggregate``, ``edge_softmax``): each row's edge range, and the
rows heavy enough to be spread over more of the card.

A power-law graph has a few hub rows with thousands of edges (20,983 into
one row of ``chip_smoke.py``'s main-path unit, 60 on average). A kernel
that gives each row one block or one warp runs the hub on one SM while the
rest of the grid drains, so both kernels take the rows with more than
``heavy_edges`` edges apart and run them first, spread wider.

On the card the plan is two small kernels (``kernels/csrc/heavy_rows.cuh``)
that each kernel's C entry point launches before its own, into scratch the
wrapper allocates: the sizes depend only on ``E``, ``n_dst`` and
``heavy_edges``, never on the data, so the wrapper never waits for the
card. :func:`plan_rows` is their plain version.
"""
from __future__ import annotations

from typing import Tuple

import torch


def heavy_slots(n_edges: int, n_dst: int, heavy_edges: int) -> int:
    """Length of the heavy list: at most ``n_edges // (heavy_edges + 1)``
    rows can have more than ``heavy_edges`` edges, and no more than
    ``n_dst`` rows exist."""
    return min(n_edges // (heavy_edges + 1), n_dst)


# rows a block of the card's planner takes (kTile in heavy_rows.cuh)
PLAN_TILE = 1024


def plan_scratch(n_edges: int, n_dst: int, heavy_edges: int,
                 device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uninitialised ``(starts, heavy)`` for the card's planner to fill:
    ``heavy`` holds the list's ``heavy_slots`` entries and after them two
    counts a tile of ``PLAN_TILE`` rows, the planner's own scratch."""
    tiles = -(-n_dst // PLAN_TILE)
    return (torch.empty(n_dst + 1, dtype=torch.int64, device=device),
            torch.empty(heavy_slots(n_edges, n_dst, heavy_edges) + 2 * tiles,
                        dtype=torch.int64, device=device))


# a heavy row with more than HUGE_FACTOR * heavy_edges edges is listed
# first (kHugeFactor in kernels/csrc/heavy_rows.cuh)
HUGE_FACTOR = 16


def plan_rows(dst: torch.Tensor, n_dst: int,
              heavy_edges: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(starts, heavy)`` for ``dst`` ``(E,)`` int32 sorted ascending: the
    plain version of the card's planner (``kernels/csrc/heavy_rows.cuh``),
    which the wrappers run inside their kernels' launch.

    ``starts`` ``(n_dst + 1,)`` int64: row ``r``'s edges are
    ``[starts[r], starts[r + 1])`` (``searchsorted`` of ``dst``; an id
    outside ``[0, n_dst)`` falls in no row). ``heavy`` ``(K,)`` int64 with
    ``K = heavy_slots(E, n_dst, heavy_edges)``: every row with more than
    ``heavy_edges`` edges exactly once, those with more than
    ``HUGE_FACTOR * heavy_edges`` first, each group in row order, then -1
    to the end. The huge rows' work is the longest, so it starts first;
    the rest keeps the reordered graph's row order, whose neighbouring rows
    share source rows in the card's L2."""
    if dst.dim() != 1:
        raise ValueError(f"dst must be 1-D, got shape {tuple(dst.shape)}")
    if heavy_edges < 0:
        raise ValueError(f"heavy_edges must be >= 0, got {heavy_edges}")
    rows = torch.arange(n_dst + 1, dtype=dst.dtype, device=dst.device)
    starts = torch.searchsorted(dst, rows)
    k = heavy_slots(dst.shape[0], n_dst, heavy_edges)
    heavy = torch.full((k,), -1, dtype=torch.int64, device=dst.device)
    if k:
        deg = starts[1:] - starts[:-1]
        huge = deg > HUGE_FACTOR * heavy_edges
        listed = torch.cat([huge.nonzero()[:, 0],
                            ((deg > heavy_edges) & ~huge).nonzero()[:, 0]])
        heavy[:listed.numel()] = listed
    return starts, heavy
