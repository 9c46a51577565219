from repro_torch.kernels.bsr_spmm.ops import (
    LAUNCHES, blockify_edges, bsr_spmm, bsr_spmm_kernel, reset_launches,
)
from repro_torch.kernels.bsr_spmm.ref import (
    bsr_spmm_np, bsr_spmm_ref, bsr_spmm_tolerance, row_nonzeros,
    spmm_edges_np, spmm_edges_ref,
)

__all__ = [
    "LAUNCHES", "blockify_edges", "bsr_spmm", "bsr_spmm_kernel",
    "reset_launches", "bsr_spmm_np", "bsr_spmm_ref", "bsr_spmm_tolerance",
    "row_nonzeros", "spmm_edges_np", "spmm_edges_ref",
]
