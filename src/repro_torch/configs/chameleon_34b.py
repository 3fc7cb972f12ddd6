"""Chameleon-34B [arXiv:2405.09818] — early-fusion VLM.

48 layers, d_model 8192, 64 heads GQA kv=8 (head_dim 128), d_ff 22016,
vocab 65536 (text + VQ image tokens share one vocabulary — early fusion means
images ARE tokens; the VQ-VAE image tokenizer is the stubbed frontend and
``input_specs`` feeds mixed token ids directly).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    source="arXiv:2405.09818",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    mlp_variant="swiglu",
    rope_theta=10_000.0,
    block_pattern=("global",),
)
