"""Mamba2-130M [arXiv:2405.21060] — SSD (state-space duality).

Attention-free SSM: 24 layers, d_model 768, d_inner 1536 (expand 2),
ssm_state 128, head_dim 64 (24 heads), vocab 50280, no FFN (d_ff=0).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=24,
    d_model=768,
    num_heads=24,          # d_inner // ssm_head_dim
    num_kv_heads=24,
    d_ff=0,
    vocab_size=50280,
    mlp_variant="none",
    block_pattern=("ssd",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    ssm_chunk=64,
    tie_embeddings=True,
)
