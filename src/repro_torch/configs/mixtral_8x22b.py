"""Mixtral-8x22B [arXiv:2401.04088].

MoE: 56 layers, d_model 6144, 48 heads GQA kv=8 (head_dim 128), expert
d_ff 16384, vocab 32768, 8 experts top-2, sliding-window attention (4096).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    source="arXiv:2401.04088",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    block_pattern=("local",),
    num_experts=8,
    num_experts_per_tok=2,
    mlp_variant="swiglu",
    rope_theta=1_000_000.0,
)
