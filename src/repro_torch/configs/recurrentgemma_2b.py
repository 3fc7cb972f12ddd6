"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427].

Hybrid: 26 layers, d_model 2560, 10 heads GQA kv=1 (head_dim 256), d_ff 7680.
Block pattern: (rglru, rglru, local-attention) — 1 attention per 2 RG-LRU
blocks; 26 layers = 8 full units + 2 trailing RG-LRU blocks. Local attention
window 2048.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    source="arXiv:2402.19427",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    sliding_window=2048,
    block_pattern=("rglru", "rglru", "local"),
    mlp_variant="geglu",
    rglru_width=2560,
    conv1d_width=4,
    tie_embeddings=True,
)
