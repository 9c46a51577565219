"""Language models (the reference's ``models/lm/``): the dense GQA
transformer's serving path (prefill through the ``flash_attention``
kernel, KV-cached decode) and its layers. MoE, MLA, sharding and training
come with their slices."""
from repro_torch.models.lm.layers import init_dense
from repro_torch.models.lm.steps import make_decode_step, make_prefill_step
from repro_torch.models.lm.transformer import (
    LM, LMConfig, init_kv_cache, init_lm_params, lm_decode_step, lm_forward,
)

__all__ = [
    "LM", "LMConfig", "init_dense", "init_kv_cache", "init_lm_params",
    "lm_decode_step", "lm_forward", "make_decode_step", "make_prefill_step",
]
