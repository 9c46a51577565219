from repro_torch.kernels.gather_scatter.ops import (
    LAUNCHES, gather_aggregate, gather_rows, reset_launches, scatter_add_,
)
from repro_torch.kernels.gather_scatter.ref import (
    gather_aggregate_ref, gather_aggregate_ref_fma, gather_rows_ref,
    scatter_add_ref, scatter_add_ref_np,
)

__all__ = [
    "LAUNCHES", "gather_aggregate", "gather_rows", "reset_launches",
    "scatter_add_", "gather_aggregate_ref", "gather_aggregate_ref_fma",
    "gather_rows_ref", "scatter_add_ref", "scatter_add_ref_np",
]
