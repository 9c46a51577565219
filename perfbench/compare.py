"""The comparison that decides ``correct``: the numbers compared with the
plain reference, and their limits (``limits/<cell>.json``).

Training: ``loss1_gap``, the relative gap of the first step's loss (the
forward at the seed's weights); ``grad_gap``, the worst leaf's gap of the
first gradient's norms (never the norm of a difference); ``grad_med_gap``,
the median leaf's; ``step_gap``, the worst leaf's gap of the norms of the
parameters' change over the checked steps. A leaf's gap is measured
against the larger of the reference's norm of that leaf and of the median
leaf. The change leaves out the leaves whose reference gradient is under
a thousandth of the median leaf's: they move under Adam by round-off
alone. The later steps' losses are not compared: Adam's first step moves
every element by about its learning rate whatever the size of its
gradient, so elements whose gradient is at rounding level take either
sign and the later losses follow them (``PERF.md``). Refresh:
``emb_gap``, the worst node's largest gap of an embedding entry against
the larger of that node's and the median node's largest reference entry.
"""
from __future__ import annotations

import math
from statistics import median
from typing import Dict, Optional, Set

import numpy as np

MOVED_SHARE = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys: Optional[Set[str]] = None) -> Dict[str, float]:
    """Each leaf's gap of norms against the larger of its own and the
    median leaf's reference norm."""
    med = median(ref.values())
    return {k: abs(prog[k] - r) / max(r, med) for k, r in ref.items()
            if keys is None or k in keys}


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    med = median(ref["grad1"].values())
    moved = {k for k, g in ref["grad1"].items() if g >= MOVED_SHARE * med}
    grad = leaf_gaps(prog["grad1"], ref["grad1"])
    return {
        "loss1_gap": abs(prog["losses"][0] - ref["losses"][0])
        / abs(ref["losses"][0]),
        "grad_gap": max(grad.values()),
        "grad_med_gap": median(grad.values()),
        "step_gap": max(leaf_gaps(prog["change"], ref["change"],
                                  moved).values()),
    }


def table_numbers(prog: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """``prog`` and ``ref`` row for row the same nodes."""
    scale = np.abs(ref).max(axis=1)
    gap = np.abs(prog.astype(np.float64) - ref).max(axis=1)
    return {"emb_gap": float((gap / np.maximum(scale,
                                               np.median(scale))).max())}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, checks)``: every number finite and within its limit."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return ok and set(numbers) == set(limits), checks
