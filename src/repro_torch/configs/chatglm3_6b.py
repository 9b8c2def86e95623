"""chatglm3-6b — dense, GQA kv=2, 2d (partial) RoPE.  [arXiv:2406.12793; hf]

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
ChatGLM applies rotary embedding to half of each head dim ("RoPE 2d").
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_head=128,
    d_ff=13696,
    vocab_size=65024,
    rope="2d",
    partial_rotary=0.5,
    norm="rmsnorm",
    mlp="swiglu",
)
