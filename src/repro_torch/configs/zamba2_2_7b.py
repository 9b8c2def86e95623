"""zamba2-2.7b — hybrid Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]

54L d_model=2560, ssm_state=64; a *shared* transformer block (32H MHA +
SwiGLU d_ff=10240) is invoked every 6 Mamba2 layers, alternating between
2 physical parameter sets (Zamba2's dual shared blocks). Sub-quadratic
backbone => runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_head=80,
    d_ff=10240,
    vocab_size=32000,
    rope="standard",
    norm="rmsnorm",
    mlp="swiglu",
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, chunk_size=256),
    shared_attn_period=6,
    n_shared_attn_blocks=2,
)
