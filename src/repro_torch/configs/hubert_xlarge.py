"""hubert-xlarge — audio encoder-only transformer.  [arXiv:2106.07447]

48L d_model=1280 16H (MHA) d_ff=5120 vocab=504 (cluster codebook head).
Encoder-only (bidirectional, non-causal): no decode shapes. The conv
waveform frontend is a STUB per assignment; ``input_specs()`` provides
precomputed frame embeddings. LayerNorm + GELU MLP, no RoPE
(conv positional embedding is part of the stubbed frontend).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_head=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    rope="none",
    norm="layernorm",
    mlp="gelu",
    frontend="frame",
)
