"""Nemotron-4-340B [arXiv:2402.16819 / 2406.11704].

Dense decoder-only: 96 layers, d_model 18432, 96 heads with GQA kv=8
(head_dim 192), d_ff 73728 with squared-ReLU MLP, vocab 256000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    source="arXiv:2402.16819",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    mlp_variant="relu2",
    rope_theta=10_000.0,
    block_pattern=("global",),
    norm="layernorm",
)
