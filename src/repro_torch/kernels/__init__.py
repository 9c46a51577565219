"""Hand-written Hopper kernels for the port's hot paths.

Each subpackage ships ``csrc/*.cu`` (CUDA C++ for sm_90a with a plain C
interface), ``ops.py`` (the ctypes-bound wrappers, their checks and launch
counts) and ``ref.py`` (the plain PyTorch versions the wrappers run on CPU
tensors, plus numpy oracles). ``_build.py`` compiles the sources with
``nvcc`` at first use; ``dispatch.py`` routes the engine's hot loops to the
kernels or to the reference path by mode and device.

- gather_scatter: ``gather_rows`` (forward and backward regather of the
  staged partition stack), ``gather_aggregate`` (one-kernel GCN
  gather+aggregate) and ``scatter_add_`` (the backward's sorted grad
  write-back).
- edge_softmax: ``edge_softmax`` (GAT's per-destination attention softmax;
  ``EdgeSoftmax`` adds its plain, deterministic backward).
- embedding_bag: ``embedding_bag`` (the two-tower model's bag mean over
  fixed-size bags; ``EmbeddingBag`` adds its dense, deterministic backward
  through ``scatter_add_``).
- flash_attention: ``flash_attention`` (the LM prefill's causal /
  sliding-window GQA attention, online softmax in float32).
- bsr_spmm: ``blockify_edges`` (COO edges to nonzero B x B blocks) and
  ``bsr_spmm`` (block-sparse ``A @ X`` over them, float32 sums, zero rows
  where a block row has no block). No engine path calls it, as in the
  reference: ``chip_smoke.py`` applies it to the GCN main path's own
  aggregate.

:func:`launch_counts` reads every kernel's launches since the last
:func:`reset_launches`.
"""
from typing import Dict

from repro_torch.kernels.bsr_spmm import ops as _bs_ops
from repro_torch.kernels.bsr_spmm.ops import (
    blockify_edges, bsr_spmm, bsr_spmm_kernel,
)
from repro_torch.kernels.bsr_spmm.ref import (
    bsr_spmm_np, bsr_spmm_ref, spmm_edges_np, spmm_edges_ref,
)
from repro_torch.kernels.edge_softmax import ops as _es_ops
from repro_torch.kernels.embedding_bag import ops as _eb_ops
from repro_torch.kernels.edge_softmax.ops import EdgeSoftmax, edge_softmax
from repro_torch.kernels.edge_softmax.ref import (
    edge_softmax_backward_ref, edge_softmax_np, edge_softmax_ref,
)
from repro_torch.kernels.embedding_bag.ops import EmbeddingBag, embedding_bag
from repro_torch.kernels.embedding_bag.ref import (
    embedding_bag_backward_ref, embedding_bag_ref,
)
from repro_torch.kernels.flash_attention import ops as _fa_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    attention_np, attention_ref, flash_attention_ref,
)
from repro_torch.kernels.gather_scatter import ops as _gs_ops
from repro_torch.kernels.gather_scatter.ops import (
    gather_aggregate, gather_rows, scatter_add_,
)
from repro_torch.kernels.gather_scatter.ref import (
    gather_aggregate_ref, gather_aggregate_ref_fma, gather_rows_ref,
    scatter_add_ref, scatter_add_ref_np,
)


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last :func:`reset_launches`."""
    return {**_gs_ops.LAUNCHES, **_es_ops.LAUNCHES, **_eb_ops.LAUNCHES,
            **_fa_ops.LAUNCHES, **_bs_ops.LAUNCHES}


def reset_launches() -> None:
    _gs_ops.reset_launches()
    _es_ops.reset_launches()
    _eb_ops.reset_launches()
    _fa_ops.reset_launches()
    _bs_ops.reset_launches()


__all__ = [
    "blockify_edges", "bsr_spmm", "bsr_spmm_kernel", "bsr_spmm_np",
    "bsr_spmm_ref", "spmm_edges_np", "spmm_edges_ref",
    "EdgeSoftmax", "EmbeddingBag", "edge_softmax", "embedding_bag",
    "flash_attention", "gather_aggregate", "gather_rows", "launch_counts",
    "reset_launches", "scatter_add_",
    "edge_softmax_backward_ref", "edge_softmax_np", "edge_softmax_ref",
    "embedding_bag_backward_ref", "embedding_bag_ref",
    "attention_np", "attention_ref", "flash_attention_ref",
    "gather_aggregate_ref", "gather_aggregate_ref_fma", "gather_rows_ref",
    "scatter_add_ref", "scatter_add_ref_np",
]
