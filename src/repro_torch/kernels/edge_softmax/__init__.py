from repro_torch.kernels.edge_softmax.ops import (
    LAUNCHES, EdgeSoftmax, edge_softmax, reset_launches,
)
from repro_torch.kernels.edge_softmax.ref import (
    edge_softmax_backward_ref, edge_softmax_np, edge_softmax_ref,
)

__all__ = [
    "LAUNCHES", "EdgeSoftmax", "edge_softmax", "reset_launches",
    "edge_softmax_backward_ref", "edge_softmax_np", "edge_softmax_ref",
]
