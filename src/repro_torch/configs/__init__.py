"""Model configurations and workload shapes (the reference's ``configs/``).
Only what the ported paths run is here so far: the recsys and LM shapes
and FLOP counts (``base.py``), the two-tower retrieval configuration
(``two_tower_retrieval.py``) and ``phi3-medium-14b``
(``phi3_medium_14b.py``). The reference's ``ArchSpec`` registry and
builders are not ported."""
from repro_torch.configs.base import (
    LM_SHAPES, RECSYS_SHAPES, lm_attention_correction, lm_model_flops,
    recsys_model_flops,
)

__all__ = [
    "LM_SHAPES", "RECSYS_SHAPES", "lm_attention_correction",
    "lm_model_flops", "recsys_model_flops",
]
