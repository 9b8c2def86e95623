"""mixtral-8x22b — MoE 8 experts top-2, GQA kv=8, SWA.  [arXiv:2401.04088; hf]

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, 8 experts top-2.
The per-assignment spec lists sliding-window attention; window follows the
Mixtral family default (4096), which makes the arch sub-quadratic and
eligible for the long_500k cell (windowed KV cache).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab_size=32768,
    sliding_window=4096,
    rope="standard",
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    mlp="swiglu",
    moe=MoEConfig(n_experts=8, experts_per_token=2, d_expert=16384),
)
