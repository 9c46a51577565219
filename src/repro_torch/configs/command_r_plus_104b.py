"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000 — GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
import torch

from repro_torch.configs.builders import make_lm_arch
from repro_torch.models.lm.transformer import LMConfig

CONFIG = LMConfig(
    name="command-r-plus-104b",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_head=128,
    d_ff=33792, vocab=256000,
    attn_type="gqa", rope_theta=75e4, dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="command-r-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8, d_ff=160,
    vocab=512, attn_type="gqa", dtype=torch.float32, q_chunk=16, kv_chunk=16,
)

ARCH = make_lm_arch(CONFIG, __doc__.strip(), SMOKE)
