"""Phi-3-mini-3.8B [arXiv:2404.14219].

Dense: 32 layers, d_model 3072, 32 heads kv=32 (head_dim 96), d_ff 8192,
vocab 32064. RoPE + SwiGLU.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    source="arXiv:2404.14219",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    mlp_variant="swiglu",
    rope_theta=10_000.0,
    block_pattern=("global",),
)
