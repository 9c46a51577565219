"""Language models (the reference's ``models/lm/``): the transformer with
GQA, sliding-window or MLA attention and dense or MoE FFNs (prefill
through the ``flash_attention`` kernel, KV-cached decode, training's
``lm_loss`` with per-layer remat), its layers, the MoE FFN, the step
builders and the placement rules."""
from repro_torch.models.lm.layers import init_dense
from repro_torch.models.lm.moe import MoEConfig, moe_ffn
from repro_torch.models.lm.steps import (
    make_decode_step, make_prefill_step, make_train_step,
)
from repro_torch.models.lm.transformer import (
    LM, LMConfig, init_kv_cache, init_lm_params, lm_decode_step, lm_forward,
    lm_loss, lm_value_and_grad,
)

__all__ = [
    "LM", "LMConfig", "MoEConfig", "init_dense", "init_kv_cache",
    "init_lm_params", "lm_decode_step", "lm_forward", "lm_loss",
    "lm_value_and_grad", "make_decode_step", "make_prefill_step",
    "make_train_step", "moe_ffn",
]
