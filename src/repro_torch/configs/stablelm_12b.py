"""stablelm-12b — dense, GQA kv=8.  [hf:stabilityai/stablelm-2-12b family]

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
StableLM-2 uses LayerNorm (no bias) and partial rotary (25%); qk-norm
per the 12b model card.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=160,
    d_ff=13824,
    vocab_size=100352,
    rope="standard",
    partial_rotary=0.25,
    qk_norm=True,
    norm="layernorm",
    mlp="swiglu",
)
