"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536(expert)
vocab=102400, MLA kv_lora=512, 2 shared + 160 routed experts top-6.
[arXiv:2405.04434; hf]"""
import torch

from repro_torch.configs.builders import make_lm_arch
from repro_torch.models.lm.moe import MoEConfig
from repro_torch.models.lm.transformer import LMConfig

CONFIG = LMConfig(
    name="deepseek-v2-236b",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_head=128,
    d_ff=12288, vocab=102400,
    attn_type="mla",
    q_lora=1536, kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    moe=MoEConfig(
        n_experts=160, top_k=6, d_ff_expert=1536,
        n_shared=2, d_ff_shared=2 * 1536,
        first_dense=1, d_ff_dense=12288,
    ),
    rope_theta=1e4, dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    name="deepseek-v2-smoke",
    n_layers=2, d_model=48, n_heads=4, n_kv_heads=4, d_head=16, d_ff=96,
    vocab=256, attn_type="mla",
    q_lora=32, kv_lora=24, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    moe=MoEConfig(
        n_experts=8, top_k=3, d_ff_expert=32, n_shared=1, d_ff_shared=32,
        first_dense=1, d_ff_dense=96,
    ),
    dtype=torch.float32, q_chunk=16, kv_chunk=16,
)

ARCH = make_lm_arch(CONFIG, __doc__.strip(), SMOKE)
