"""SeamlessM4T-large-v2 [arXiv:2308.11596] — transformer backbone only.

Encoder-decoder: 24 encoder + 24 decoder layers, d_model 1024, 16 heads
(kv=16 — full MHA), d_ff 8192, vocab 256206. The modality frontend
(mel-spectrogram + conv feature extractor) is a STUB: ``input_specs`` feeds
precomputed frame embeddings of shape (batch, frames, d_model) to the encoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    source="arXiv:2308.11596",
    num_layers=24,
    num_encoder_layers=24,
    encoder_frames_ratio=4,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    mlp_variant="gelu",
    norm="layernorm",
    block_pattern=("global",),
)
