"""LM front-end: ModelConfig x ShapeConfig profiled into the Workload IR.

The port's copy of the reference's
``repro.core.workload.frontends.lm``: the analytic per-layer profile
(``lm_block_ops``), its ``weight_dtype``/``kv_dtype`` int8 accounting,
and ``lm_workload``, which the tuner derives its cases from and the
measured model prices. Keep the two in step: the parity tests compare
them op by op, every field exactly.
"""
from __future__ import annotations

from typing import List, Optional, Union

from repro_torch.configs import get_arch, get_shape
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.workload.ir import Op, OpInfo, Workload, dtype_bytes


def _bpe(dtype: str = "bfloat16") -> int:
    return {"bfloat16": 2, "float32": 4, "int8": 1}[dtype]


def lm_block_ops(
    cfg: ModelConfig,
    seq: int,
    batch: int,
    kind: str,
    kv_len: Optional[int] = None,
    weight_dtype: Optional[str] = None,
    kv_dtype: Optional[str] = None,
) -> List[Op]:
    """Profile one model into per-layer Op records.

    kind: 'train' (fwd; trainer scales by 3x for bwd), 'prefill', 'decode'
    (decode: kv_len (default seq) tokens of KV cache, 1 new token per
    sequence).

    ``weight_dtype``/``kv_dtype`` declare the storage precision of the
    weights and of the attention KV cache (default: ``cfg.dtype``, which
    reproduces the historical byte accounting exactly). An int8 KV cache
    additionally accounts the per-(token, head) bf16 scale side-band the
    serving engine allocates; int8 weight per-channel scales are O(1/d)
    of the weight bytes and are not modeled.
    """
    bpe = _bpe(cfg.dtype)
    wdt = weight_dtype or cfg.dtype
    kdt = kv_dtype or cfg.dtype
    wbpe = dtype_bytes(wdt)
    kv_elem = dtype_bytes(kdt) + (2.0 if kdt == "int8" else 0.0) / max(
        cfg.head_dim, 1)
    d = cfg.d_model
    ops: List[Op] = []
    if kind == "decode":
        q_tokens = batch                      # one new token per sequence
        kv_len = kv_len if kv_len is not None else seq
        if cfg.sliding_window:
            kv_len = min(kv_len, cfg.sliding_window)
    else:
        q_tokens = batch * seq
        kv_len = seq

    tok_bytes = q_tokens * d * bpe

    # Embedding gather
    ops.append(OpInfo("embed", "embed", 0.0, cfg.vocab_size * d * wbpe,
                      q_tokens * 4, tok_bytes, -1, "vocab",
                      cfg.vocab_size, weight_dtype=wdt))

    attn_layers = set(cfg.attention_layer_indices())
    ssm_layers = set(cfg.ssm_layer_indices())
    hd, nq, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    for li in range(cfg.n_layers):
        if li in attn_layers:
            qkv_w = (d * nq * hd + 2 * d * nkv * hd) * wbpe
            o_w = nq * hd * d * wbpe
            qkv_flops = 2 * q_tokens * d * (nq + 2 * nkv) * hd
            o_flops = 2 * q_tokens * nq * hd * d
            ops.append(OpInfo(f"L{li}.qkv", "matmul", qkv_flops, qkv_w,
                              tok_bytes,
                              q_tokens * (nq + 2 * nkv) * hd * bpe, li,
                              "heads", nq, weight_dtype=wdt))
            # attention scores+pv; causal halves the effective kv per query
            eff_kv = kv_len
            if cfg.causal and kind != "decode":
                eff_kv = kv_len / 2
                if cfg.sliding_window:
                    eff_kv = min(eff_kv, cfg.sliding_window)
            attn_flops = 2 * 2 * q_tokens * nq * hd * eff_kv
            kv_bytes = batch * kv_len * nkv * hd * 2 * kv_elem
            ops.append(OpInfo(f"L{li}.attn", "attention", attn_flops, 0.0,
                              q_tokens * nq * hd * bpe + kv_bytes,
                              q_tokens * nq * hd * bpe, li,
                              "heads_full", nq, act_dtype=kdt))
            ops.append(OpInfo(f"L{li}.attn_out", "matmul", o_flops, o_w,
                              q_tokens * nq * hd * bpe, tok_bytes, li,
                              "heads", nq, weight_dtype=wdt))
            # FFN (dense or MoE)
            if cfg.moe is not None:
                m = cfg.moe
                ops.append(OpInfo(f"L{li}.router", "router",
                                  2 * q_tokens * d * m.n_experts,
                                  d * m.n_experts * wbpe, tok_bytes,
                                  q_tokens * m.n_experts * 4, li,
                                  "experts", m.n_experts,
                                  weight_dtype=wdt))
                expert_flops = (2 * q_tokens * m.experts_per_token * 3 * d
                                * m.d_expert)
                expert_w = m.n_experts * 3 * d * m.d_expert * wbpe
                ops.append(OpInfo(f"L{li}.experts", "matmul", expert_flops,
                                  expert_w, tok_bytes * m.experts_per_token,
                                  tok_bytes, li, "experts", m.n_experts,
                                  weight_dtype=wdt))
                if m.n_shared_experts:
                    sh = m.n_shared_experts * (m.d_shared_expert or m.d_expert)
                    ops.append(OpInfo(f"L{li}.shared_expert", "matmul",
                                      2 * q_tokens * 3 * d * sh,
                                      3 * d * sh * wbpe, tok_bytes,
                                      tok_bytes, li, "ffn", sh,
                                      weight_dtype=wdt))
            elif cfg.d_ff:
                nmat = 3 if cfg.mlp == "swiglu" else 2
                ops.append(OpInfo(f"L{li}.mlp", "matmul",
                                  2 * q_tokens * nmat * d * cfg.d_ff,
                                  nmat * d * cfg.d_ff * wbpe,
                                  tok_bytes,
                                  tok_bytes, li, "ffn", cfg.d_ff,
                                  weight_dtype=wdt))
        if li in ssm_layers and cfg.ssm is not None:
            s = cfg.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            proj_out_dim = 2 * di + 2 * s.n_groups * s.d_state + nh
            proj_in = d * proj_out_dim
            ops.append(OpInfo(f"L{li}.ssm_in", "matmul",
                              2 * q_tokens * proj_in, proj_in * wbpe,
                              tok_bytes, q_tokens * proj_out_dim * bpe, li,
                              "ssm_inner", proj_out_dim,
                              weight_dtype=wdt))
            # SSD scan: per token, per head: state update + output
            # ~ 6 * d_state flops per channel (dA*h + B x outer + C y inner)
            scan_flops = 6.0 * q_tokens * di * s.d_state
            state_bytes = batch * nh * s.head_dim * s.d_state * 4
            ops.append(OpInfo(f"L{li}.ssd_scan", "scan", scan_flops,
                              0.0, q_tokens * di * bpe + state_bytes,
                              q_tokens * di * bpe, li, "ssm_heads", nh))
            ops.append(OpInfo(f"L{li}.ssm_out", "matmul",
                              2 * q_tokens * di * d, di * d * wbpe,
                              q_tokens * di * bpe, tok_bytes, li,
                              "ssm_inner", di, weight_dtype=wdt))

    # LM head (skip for encoder-only training repr — hubert predicts codes,
    # still a d x vocab matmul)
    ops.append(OpInfo("lm_head", "matmul",
                      2 * q_tokens * d * cfg.vocab_size,
                      d * cfg.vocab_size * wbpe, tok_bytes,
                      q_tokens * cfg.vocab_size * bpe, -1, "vocab",
                      cfg.vocab_size, weight_dtype=wdt))
    return ops


def profile_arch(cfg: ModelConfig, shape: ShapeConfig,
                 kv_len: Optional[int] = None,
                 weight_dtype: Optional[str] = None,
                 kv_dtype: Optional[str] = None) -> List[Op]:
    """Legacy list view; ``shape.kv_len`` (or the override) reaches the
    decode profile instead of being dropped."""
    kv = kv_len if kv_len is not None else getattr(shape, "kv_len", None)
    return lm_block_ops(cfg, shape.seq_len, shape.global_batch, shape.kind,
                        kv_len=kv, weight_dtype=weight_dtype,
                        kv_dtype=kv_dtype)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) per assignment."""
    n = cfg.param_count(active_only=cfg.moe is not None)
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch   # decode: one token per sequence


def lm_workload(cfg: Union[ModelConfig, str],
                shape: Union[ShapeConfig, str],
                kv_len: Optional[int] = None,
                weight_dtype: Optional[str] = None,
                kv_dtype: Optional[str] = None) -> Workload:
    """The LM front-end proper: (arch, shape) -> Workload.

    Accepts registry ids of the port ('minicpm-2b', 'prefill_32k') or
    the config objects themselves (smoke configs included).
    ``weight_dtype``/``kv_dtype`` declare storage precision for weights
    and the KV cache (default ``cfg.dtype``; see :func:`lm_block_ops`).
    """
    if isinstance(cfg, str):
        cfg = get_arch(cfg)
    if isinstance(shape, str):
        shape = get_shape(shape)
    kv = kv_len if kv_len is not None else getattr(shape, "kv_len", None)
    ops = tuple(profile_arch(cfg, shape, kv_len=kv,
                             weight_dtype=weight_dtype, kv_dtype=kv_dtype))
    return Workload(
        name=f"{cfg.name}/{shape.name}",
        frontend="lm",
        ops=ops,
        kind=shape.kind,
        meta={
            "arch": cfg.name, "family": cfg.family, "shape": shape.name,
            "seq_len": shape.seq_len, "global_batch": shape.global_batch,
            "kv_len": kv, "n_layers": cfg.n_layers,
            "params": cfg.param_count(),
            "weight_dtype": weight_dtype or cfg.dtype,
            "kv_dtype": kv_dtype or cfg.dtype,
        },
        model_flops_hint=model_flops(cfg, shape),
    )
