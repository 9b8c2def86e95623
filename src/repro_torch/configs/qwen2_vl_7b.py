"""qwen2-vl-7b — VLM backbone, M-RoPE.  [arXiv:2409.12191; hf]

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
Per assignment the vision frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings; the backbone applies M-RoPE with
(temporal, height, width) sections (16, 24, 24) over the 128-dim head.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab_size=152064,
    rope="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    mlp="swiglu",
    frontend="patch",
)
