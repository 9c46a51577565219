"""The benchmark's own arithmetic: the table of peaks, the model FLOPs of
a step, and each hand-written kernel's launches and bytes on the main
path, worked out from the partition plan's units.

Bytes count each input byte the launch needs read once and each output
byte written once (the least traffic the launch could make), so a
roofline share from them is never above what the kernel achieved.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from perfbench.reference import family

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


def peaks_for(kind: str) -> Optional[dict]:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``)
    or None for a card the table does not hold."""
    for key, val in PEAKS.items():
        if key in kind:
            return val
    return None


def step_flops(config: dict, entry: str, n_nodes: int, n_edges: int) -> float:
    """Model FLOPs of one step: a forward for a refresh; forward and
    backward (three forwards, no recompute) for a training epoch."""
    fwd = family(config["model"]).forward_flops(config, n_nodes, n_edges)
    return fwd if entry == "refresh" else 3.0 * fwd


def _contiguous(rows: np.ndarray) -> bool:
    return bool(rows.size) and int(rows[-1]) - int(rows[0]) + 1 == rows.size


def kernel_launches(plan, dims, entry: str) -> Dict[str, Tuple[int, float]]:
    """``{kernel: (launches, bytes)}`` of one step on the kernel path.

    ``gather_rows`` regathers a unit's ``r_pad`` rows from its staged
    stack, once a layer in the forward and once again in the regather
    backward: it reads the ``n_req`` distinct rows (and the zero pad row
    when ``r_pad > n_req``) and the int32 row map, and writes ``r_pad``
    rows. ``scatter_add`` is the backward's ∇A write-back of layers ``l >
    0``, one launch for each unit and source partition whose rows are not
    one contiguous run: it reads the values, the int32 rows and the base
    rows and writes the base rows."""
    n_layers = len(dims) - 1
    passes = 1 if entry == "refresh" else 2
    g_n, g_b = 0, 0.0
    s_n, s_b = 0, 0.0
    for u in plan.units:
        distinct = u.n_req + (1 if u.r_pad > u.n_req else 0)
        for layer in range(n_layers):
            d = dims[layer]
            g_n += passes
            g_b += passes * (4.0 * distinct * d + 4.0 * u.r_pad
                             + 4.0 * u.r_pad * d)
        if entry == "refresh":
            continue
        ptr = u.req_part_ptr
        for layer in range(1, n_layers):
            d = dims[layer]
            for q in u.req_parts:
                a0 = int(plan.ro.part_ptr[q])
                rows = u.req_global[ptr[q]:ptr[q + 1]] - a0
                if rows.size and not _contiguous(rows):
                    s_n += 1
                    s_b += 3.0 * 4.0 * rows.size * d + 4.0 * rows.size
    out = {"gather_rows": (g_n, g_b)}
    if entry != "refresh":
        out["scatter_add"] = (s_n, s_b)
    return out
