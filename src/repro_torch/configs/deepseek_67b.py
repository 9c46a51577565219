"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400 — llama-arch. [arXiv:2401.02954; hf]"""
import torch

from repro_torch.configs.builders import make_lm_arch
from repro_torch.models.lm.transformer import LMConfig

CONFIG = LMConfig(
    name="deepseek-67b",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=22016, vocab=102400,
    attn_type="gqa", rope_theta=1e4, dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="deepseek-67b-smoke",
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_head=8, d_ff=128,
    vocab=256, attn_type="gqa", dtype=torch.float32, q_chunk=16, kv_chunk=16,
)

ARCH = make_lm_arch(CONFIG, __doc__.strip(), SMOKE)
