"""mamba2-1.3b — pure SSM, SSD (state-space duality).  [arXiv:2405.21060]

48L d_model=2048, attention-free, ssm_state=128, d_inner=2*d_model,
head_dim=64 (=> 64 SSD heads). No MLP (d_ff=0): Mamba-2 blocks only.
Attention-sharding recipes are inapplicable (noted in DESIGN.md); the
DSE explores dp x tp over (d_inner, d_state) instead. Runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,          # unused (attention-free)
    n_kv_heads=1,
    d_head=64,
    d_ff=0,
    vocab_size=50280,
    rope="none",
    norm="rmsnorm",
    mlp="swiglu",
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk_size=256),
)
