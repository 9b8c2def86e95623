"""Architecture configuration dataclasses (the port's own copy).

Pure data, no framework import. This is a copy of the reference
package's ``repro.configs.base`` (``ModelConfig``, ``smoke_config``):
the port imports nothing of that package, so it carries the records it
needs. Keep the two in step: the parity tests build both from the same
arch id and compare them field by field.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    d_expert: int                  # per-expert FFN hidden dim
    n_shared_experts: int = 0      # always-on experts (Qwen2-MoE style)
    d_shared_expert: int = 0       # hidden dim of each shared expert
    router_aux_loss: float = 0.01
    capacity_factor: float = 1.25  # only used for dropping-capacity EP paths


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2                # d_inner = expand * d_model
    head_dim: int = 64             # Mamba-2 SSD head dim
    n_groups: int = 1
    chunk_size: int = 256          # SSD chunked-scan block length

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                # 0 -> d_model // n_heads
    # --- attention flavour -------------------------------------------------
    causal: bool = True
    sliding_window: int = 0        # 0 = full attention
    rope: str = "standard"         # standard | 2d | mrope | none
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0    # fraction of head dim that rotates
    mrope_sections: Tuple[int, ...] = ()   # Qwen2-VL M-RoPE splits
    qk_norm: bool = False
    # --- block flavour ------------------------------------------------------
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    mlp: str = "swiglu"            # swiglu | gelu (plain 2-matmul)
    tie_embeddings: bool = False
    # --- mixtures / state space --------------------------------------------
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_period: int = 0
    n_shared_attn_blocks: int = 2
    # --- modality frontends -------------------------------------------------
    frontend: str = "token"        # token | patch | frame
    # --- training-time details ----------------------------------------------
    lr_schedule: str = "cosine"    # cosine | wsd
    # --- numerics -----------------------------------------------------------
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    def param_count(self) -> int:
        """Parameters of a dense config (the only family the port runs)."""
        if self.family != "dense":
            raise NotImplementedError(
                f"param_count for family {self.family!r} is not ported yet")
        d, v = self.d_model, self.vocab_size
        total = d * v * (1 if self.tie_embeddings else 2)
        hd, nq, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
        mlp = (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
        total += self.n_layers * (attn + mlp)
        total += 2 * self.n_layers * d + d          # norms
        return int(total)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_head=16,
        d_ff=128,
        vocab_size=256,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            n_experts=4,
            experts_per_token=min(2, cfg.moe.experts_per_token),
            d_expert=32,
            n_shared_experts=min(1, cfg.moe.n_shared_experts),
            d_shared_expert=32 if cfg.moe.n_shared_experts else 0,
        )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk_size=32)
    if cfg.shared_attn_period:
        kw["n_layers"] = 4
        kw["shared_attn_period"] = 2
    if cfg.sliding_window:
        kw["sliding_window"] = 32
    if cfg.mrope_sections:
        kw["mrope_sections"] = (4, 2, 2)
    return cfg.replace(**kw)
