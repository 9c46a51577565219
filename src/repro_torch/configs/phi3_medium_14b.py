"""phi3-medium-14b [dense]: 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]

``CONFIG`` is the published configuration (14,659,502,080 parameters,
29.3 GB in bf16); ``SMOKE`` the reference launcher's smoke size (2 layers,
d_model 64, float32, attention chunks of 16)."""
import torch

from repro_torch.configs.builders import make_lm_arch
from repro_torch.models.lm.transformer import LMConfig

CONFIG = LMConfig(
    name="phi3-medium-14b",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_head=128,
    d_ff=17920, vocab=100352,
    attn_type="gqa", rope_theta=1e4, dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="phi3-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8, d_ff=128,
    vocab=256, attn_type="gqa", dtype=torch.float32, q_chunk=16, kv_chunk=16,
)

ARCH = make_lm_arch(CONFIG, __doc__.split("\n\n", 1)[0].strip(), SMOKE)
