"""Architecture registry: ``--arch <id>`` resolution for the launchers
(the reference's ``configs/``).

The registry holds the reference's eleven arch ids in its order: the LMs
``mixtral-8x7b`` (MoE, sliding window), ``deepseek-v2-236b`` (MoE and
MLA), ``phi3-medium-14b``, ``command-r-plus-104b`` and ``deepseek-67b``,
then ``graphsage-reddit``, ``pna``, ``graphcast``, ``gcn-cora``,
``two-tower-retrieval`` and the paper's own ``gcn-igbm-3l`` (not
assigned). ``base`` holds the shapes and FLOP counts.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs.base import (
    GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, ArchSpec, Built, Cell,
    gnn_model_flops, lm_attention_correction, lm_model_flops, mfg_hop_sizes,
    recsys_model_flops,
)

_MODULES = [
    "mixtral_8x7b",
    "deepseek_v2_236b",
    "phi3_medium_14b",
    "command_r_plus_104b",
    "deepseek_67b",
    "graphsage_reddit",
    "pna",
    "graphcast",
    "gcn_cora",
    "two_tower_retrieval",
    "gcn_igbm",
]

ASSIGNED = [
    "mixtral-8x7b", "deepseek-v2-236b", "phi3-medium-14b",
    "command-r-plus-104b", "deepseek-67b",
    "graphsage-reddit", "pna", "graphcast", "gcn-cora",
    "two-tower-retrieval",
]


def _load() -> Dict[str, ArchSpec]:
    import importlib

    reg = {}
    for m in _MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{m}")
        reg[mod.ARCH.name] = mod.ARCH
    return reg


REGISTRY: Dict[str, ArchSpec] = _load()


def get_arch(name: str) -> ArchSpec:
    return REGISTRY[name]


def list_cells(assigned_only: bool = True) -> List[Tuple[str, str, Cell]]:
    """All (arch, shape, cell) combinations of the registered archs (of
    the assigned ones only by default: 40 cells)."""
    out = []
    names = ASSIGNED if assigned_only else list(REGISTRY)
    for name in names:
        arch = REGISTRY[name]
        for shape, cell in arch.cells.items():
            out.append((name, shape, cell))
    return out


__all__ = [
    "ASSIGNED", "ArchSpec", "Built", "Cell", "GNN_SHAPES", "LM_SHAPES",
    "RECSYS_SHAPES", "REGISTRY", "get_arch", "gnn_model_flops",
    "list_cells", "lm_attention_correction", "lm_model_flops",
    "mfg_hop_sizes", "recsys_model_flops",
]
