from repro_torch.kernels.flash_attention.ops import (
    LAUNCHES, flash_attention, reset_launches,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_np, attention_ref, flash_attention_ref,
)

__all__ = [
    "LAUNCHES", "flash_attention", "reset_launches",
    "attention_np", "attention_ref", "flash_attention_ref",
]
