from repro_torch.kernels.embedding_bag.ops import (
    LAUNCHES, EmbeddingBag, embedding_bag, reset_launches,
)
from repro_torch.kernels.embedding_bag.ref import (
    embedding_bag_backward_ref, embedding_bag_ref,
)

__all__ = [
    "LAUNCHES", "EmbeddingBag", "embedding_bag", "reset_launches",
    "embedding_bag_backward_ref", "embedding_bag_ref",
]
