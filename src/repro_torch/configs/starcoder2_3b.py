"""starcoder2-3b — dense, GQA kv=2, RoPE.  [arXiv:2402.19173; hf]

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.
StarCoder2 uses LayerNorm and a plain GELU MLP (non-gated, 4x).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_head=128,
    d_ff=12288,
    vocab_size=49152,
    rope="standard",
    rope_theta=100_000.0,
    norm="layernorm",
    mlp="gelu",
)
