from repro_torch.kernels.gather_scatter.ops import (
    LAUNCHES, gather_aggregate, gather_rows, reset_launches,
)
from repro_torch.kernels.gather_scatter.ref import (
    gather_aggregate_ref, gather_aggregate_ref_fma, gather_rows_ref,
)

__all__ = [
    "LAUNCHES", "gather_aggregate", "gather_rows", "reset_launches",
    "gather_aggregate_ref", "gather_aggregate_ref_fma", "gather_rows_ref",
]
