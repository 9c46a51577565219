"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088; hf]"""
import torch

from repro_torch.configs.builders import make_lm_arch
from repro_torch.models.lm.moe import MoEConfig
from repro_torch.models.lm.transformer import LMConfig

CONFIG = LMConfig(
    name="mixtral-8x7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=32000,
    attn_type="gqa", window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
    rope_theta=1e6, dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="mixtral-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=128, vocab=256, attn_type="gqa", window=16,
    moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
    dtype=torch.float32, q_chunk=16, kv_chunk=16,
)

ARCH = make_lm_arch(CONFIG, __doc__.strip(), SMOKE)
