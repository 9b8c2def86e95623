"""qwen2-moe-a2.7b — 60 routed experts top-4 + 4 shared.  [hf:Qwen/Qwen1.5-MoE-A2.7B]

24L d_model=2048 16H (kv=16) moe d_ff=1408 vocab=151936, MoE 60e top-4,
4 shared experts (merged shared intermediate = 4x1408 = 5632).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab_size=151936,
    rope="standard",
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    mlp="swiglu",
    moe=MoEConfig(
        n_experts=60,
        experts_per_token=4,
        d_expert=1408,
        n_shared_experts=4,
        d_shared_expert=1408,
    ),
)
