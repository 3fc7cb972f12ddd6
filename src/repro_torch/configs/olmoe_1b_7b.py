"""OLMoE-1B-7B [arXiv:2409.02060].

MoE: 16 layers, d_model 2048, 16 heads (kv=16), expert d_ff 1024,
vocab 50304, 64 experts top-8, full attention.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="arXiv:2409.02060",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    num_experts=64,
    num_experts_per_tok=8,
    moe_d_ff=1024,
    mlp_variant="swiglu",
    rope_theta=10_000.0,
    block_pattern=("global",),
)
