"""Architecture configuration dataclasses (the port's own copy).

Pure data, no framework import. This is a copy of the reference
package's ``repro.configs.base`` (``ModelConfig``, ``ShapeConfig``,
``SHAPES``, ``smoke_config``, ``shape_skip_reason``): the port imports
nothing of that package, so it carries the records it needs,
``param_count`` included. Keep the two in step: the parity tests build
both from the same arch id and compare them field by field.
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
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k cell (the reference's rule)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def attention_layer_indices(self) -> Tuple[int, ...]:
        """Layer indices that run an attention block."""
        if self.family == "ssm":
            return ()
        if self.family == "hybrid" and self.shared_attn_period:
            return tuple(
                i for i in range(self.n_layers)
                if (i + 1) % self.shared_attn_period == 0
            )
        return tuple(range(self.n_layers))

    def ssm_layer_indices(self) -> Tuple[int, ...]:
        if self.family in ("ssm", "hybrid"):
            return tuple(range(self.n_layers))  # every layer has a mixer
        return ()

    def param_count(self, active_only: bool = False) -> int:
        """Parameters of the config, as the reference counts them
        (``active_only``: only the routed experts a token uses)."""
        d, v = self.d_model, self.vocab_size
        total = d * v                                  # embeddings
        if not self.tie_embeddings:
            total += d * v                             # unembed
        hd, nq, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * (nq * hd) + 2 * d * (nkv * hd) + (nq * hd) * d
        if self.mlp == "swiglu":
            dense_mlp = 3 * d * self.d_ff
        else:
            dense_mlp = 2 * d * self.d_ff
        n_attn = len(self.attention_layer_indices())
        n_ssm = len(self.ssm_layer_indices())
        if self.family == "hybrid":
            # shared attention blocks: parameters exist once per block
            total += self.n_shared_attn_blocks * (attn + dense_mlp)
            n_attn = 0
        if self.ssm is not None:
            di = self.ssm.d_inner(d)
            nh = self.ssm.n_heads(d)
            gn = self.ssm.n_groups * self.ssm.d_state
            # in_proj (z,x,B,C,dt) + out_proj + conv + A,D
            ssm_params = (d * (2 * di + 2 * gn + nh) + di * d
                          + self.ssm.d_conv * (di + 2 * gn) + 2 * nh)
            total += n_ssm * ssm_params
        if self.moe is not None:
            m = self.moe
            per_expert = 3 * d * m.d_expert
            router = d * m.n_experts
            shared = m.n_shared_experts * 3 * d * (m.d_shared_expert
                                                   or m.d_expert)
            n_used = m.experts_per_token if active_only else m.n_experts
            total += n_attn * (attn + router + n_used * per_expert + shared)
        elif self.family not in ("ssm", "hybrid"):
            total += n_attn * (attn + dense_mlp)
        total += 2 * self.n_layers * d + d          # norms
        return int(total)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes of the LM cells (seq_len x global_batch), as the reference's.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode
    # decode only: the KV-cache length when it differs from seq_len;
    # None -> seq_len
    kv_len: Optional[int] = None


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


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


def shape_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """The reference's rules: which (arch x shape) cells are excluded."""
    if shape.kind == "decode" and cfg.is_encoder_only:
        return "encoder-only architecture has no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return "pure full-attention arch: 524k context requires sub-quadratic attention"
    return None
