"""Language-model layers (the reference's ``models/lm/``). Only
:func:`~repro_torch.models.lm.layers.init_dense`, which the two-tower model
shares, is ported so far."""
from repro_torch.models.lm.layers import init_dense

__all__ = ["init_dense"]
