"""Gemma-3-12B [hf:google/gemma-3-1b-pt family card, scaled per assignment].

Dense: 48 layers, d_model 3840, 16 heads GQA kv=8 (head_dim 256), d_ff 15360,
vocab 262144. 5:1 local:global layer interleave, sliding window 1024 on local
layers, 128k context via the global layers. Attention logit softcapping and
RMSNorm per the Gemma family.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    sliding_window=1024,
    block_pattern=("local", "local", "local", "local", "local", "global"),
    mlp_variant="geglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
