"""Mixture-of-Experts FFN of the port: top-k token-choice routing, the
dropless grouped-GEMM path and the GShard capacity path (counterpart of
``repro.models.moe``).

* dropless (``dropless=True``: decode, and prefill under
  ``ModelRuntime.moe_dropless``): every token's K rows run through the
  policy's ``moe_gemm`` choice: the ``torch`` impl, three dispatches
  that each loop over the experts, or the ``cuda`` impl, the grouped
  kernel's three products on rows sorted once per layer
  (``kernels.moe_gemm.moe_gemm_glu``);
* capacity (the reference's default for ``forward``/prefill): each
  expert takes at most ``ceil(K T / E * capacity_factor)`` tokens; the
  overflow falls through the residual. The reference's dense einsum
  dispatch (``(T, E, C)`` one-hots) becomes an index gather and an
  index-add of the kept rows, which computes the same sums.

Both paths consume :func:`_route`, so the policy cannot change routing.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import (TORCH_POLICY, KernelPolicy,
                                          dispatch, fused_call,
                                          resolve_policy)
from repro_torch.kernels.moe_gemm import moe_gemm_glu
from repro_torch.models.layers import ParamDef, swiglu


def moe_defs(cfg: ModelConfig, stack: Tuple[int, ...] = ()) -> Dict:
    """Parameter defs for one MoE FFN (optionally layer-stacked)."""
    m = cfg.moe
    d = cfg.d_model
    defs = {
        "router": ParamDef(stack + (d, m.n_experts)),
        "wi": ParamDef(stack + (m.n_experts, d, m.d_expert)),
        "wg": ParamDef(stack + (m.n_experts, d, m.d_expert)),
        "wo": ParamDef(stack + (m.n_experts, m.d_expert, d)),
    }
    if m.n_shared_experts:
        ff_sh = m.n_shared_experts * (m.d_shared_expert or m.d_expert)
        defs["shared_wi"] = ParamDef(stack + (d, ff_sh))
        defs["shared_wg"] = ParamDef(stack + (d, ff_sh))
        defs["shared_wo"] = ParamDef(stack + (ff_sh, d))
        defs["shared_gate"] = ParamDef(stack + (d, 1))
    return defs


def moe_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
            dropless: bool = False, token_chunk: int = 0,
            policy: Optional[KernelPolicy] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss f32 scalar).

    ``dropless`` keeps every token (decode; serving prefill). Otherwise
    tokens over an expert's capacity are dropped, per GShard token group
    of ``token_chunk`` tokens when that divides S (0: one group)."""
    m = cfg.moe
    B, S, d = x.shape
    if dropless:
        out, aux = _routed_grouped(p, x.reshape(B * S, d), cfg, policy)
        return _add_shared(p, x, out.reshape(B, S, d), cfg), aux
    if token_chunk and S % token_chunk == 0 and token_chunk < S:
        return _moe_ffn_grouped(p, x, cfg, token_chunk)
    T = B * S
    cap = int(math.ceil(m.experts_per_token * T / m.n_experts
                        * m.capacity_factor))
    cap = max(m.experts_per_token, min(cap, T))
    out, aux = _routed_core(p, x.reshape(T, d), cfg, cap)
    return _add_shared(p, x, out.reshape(B, S, d), cfg), aux


def _route(p: Dict[str, torch.Tensor], xt: torch.Tensor, cfg: ModelConfig,
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k token-choice routing in f32, shared by every path.

    xt: (T, d) -> (gate_vals (T, K) normalised, idx (T, K) int64, aux).
    Ties go to the lower expert index, as ``jax.lax.top_k`` breaks them
    (``torch.topk`` promises no order): the first K of a stable
    descending sort."""
    m = cfg.moe
    E, K = m.n_experts, m.experts_per_token
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    gate_vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = gate_vals[:, :K], idx[:, :K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # aux load-balancing loss (Switch/GShard form)
    me = probs.mean(dim=0)                                      # (E,)
    ce = F.one_hot(idx, E).float().sum(dim=1).mean(dim=0) / K   # routed frac
    aux = E * torch.sum(me * ce) * m.router_aux_loss
    return gate_vals, idx, aux


def _routed_grouped(p, xt: torch.Tensor, cfg: ModelConfig,
                    policy: Optional[KernelPolicy],
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless expert compute as grouped GEMMs over (token, k) rows: each
    token is repeated K times (one row per chosen expert), the three
    expert matmuls follow the policy's ``moe_gemm`` choice and the K
    outputs are gate-combined. Under ``cuda`` the three products share
    one sort by expert (the layout depends on the routing alone)."""
    m = cfg.moe
    T, d = xt.shape
    E, K = m.n_experts, m.experts_per_token
    gate_vals, idx, aux = _route(p, xt, cfg)
    x_rep = xt.repeat_interleave(K, dim=0)                      # (T*K, d)
    eor = idx.reshape(T * K).to(torch.int32)                    # row -> expert
    wg, wi, wo = (p[n].to(xt.dtype) for n in ("wg", "wi", "wo"))
    if resolve_policy(policy).impl_for("moe_gemm") == "cuda":
        y = fused_call("moe_gemm_glu", moe_gemm_glu, _EXPERT_GLU_TORCH,
                       x_rep, wg, wi, wo, eor, act=swiglu, n_experts=E)
    else:
        y = _expert_glu(x_rep, wg, wi, wo, eor, act=swiglu, n_experts=E,
                        policy=policy)                          # (T*K, d)
    y = y.reshape(T, K, d) * gate_vals[..., None].to(y.dtype)
    return y.sum(dim=1), aux


def _expert_glu(x, wg, wi, wo, expert_of_row, *, act, n_experts: int,
                policy: Optional[KernelPolicy]) -> torch.Tensor:
    """``act(x @ wg[e], x @ wi[e]) @ wo[e]`` for each row's expert as
    three ``moe_gemm`` dispatches."""
    g = dispatch("moe_gemm", policy, x, wg, expert_of_row,
                 n_experts=n_experts)
    u = dispatch("moe_gemm", policy, x, wi, expert_of_row,
                 n_experts=n_experts)
    return dispatch("moe_gemm", policy, act(g, u), wo, expert_of_row,
                    n_experts=n_experts)


#: The sort-once path's gradient: the ``torch`` impl's three dispatches.
_EXPERT_GLU_TORCH = functools.partial(_expert_glu, policy=TORCH_POLICY)


def _routed_core(p, xt: torch.Tensor, cfg: ModelConfig, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded dispatch for one token group. xt: (T, d).

    A (token, k) slot's position in its expert's buffer is the count of
    earlier slots (token-major, then k) routed to the same expert; slots
    at positions >= ``cap`` are dropped. The reference computes those
    counts with a strictly lower-triangular matmul for small groups and
    a cumsum for large ones; both give the same exact integers, so one
    cumsum serves here."""
    m = cfg.moe
    T, d = xt.shape
    E, K = m.n_experts, m.experts_per_token
    gate_vals, idx, aux = _route(p, xt, cfg)
    choice = F.one_hot(idx.reshape(T * K), E)                   # (T*K, E)
    pos_in_e = ((torch.cumsum(choice, dim=0) - choice) * choice).sum(-1)
    keep = pos_in_e < cap                                       # (T*K,)
    tok = torch.arange(T, device=xt.device).repeat_interleave(K)[keep]
    e_k = idx.reshape(T * K)[keep]
    slot = e_k * cap + pos_in_e[keep]                           # (e, c) flat

    xe = xt.new_zeros((E * cap, d))
    xe[slot] = xt[tok]
    xe = xe.reshape(E, cap, d)
    h = swiglu(torch.bmm(xe, p["wg"].to(xe.dtype)),
               torch.bmm(xe, p["wi"].to(xe.dtype)))
    ye = torch.bmm(h, p["wo"].to(h.dtype)).reshape(E * cap, d)
    gate = gate_vals.reshape(T * K)[keep].to(xt.dtype)
    out = xt.new_zeros((T, d))
    out.index_add_(0, tok, ye[slot] * gate[:, None])
    return out, aux


def _moe_ffn_grouped(p, x: torch.Tensor, cfg: ModelConfig, token_chunk: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard token groups: each ``token_chunk``-token group of a row is
    dispatched on its own, with capacity ``ceil(K Tc / E * cf)``."""
    m = cfg.moe
    B, S, d = x.shape
    K, E = m.experts_per_token, m.n_experts
    cap = int(math.ceil(K * token_chunk / E * m.capacity_factor))
    cap = max(K, min(cap, token_chunk))
    groups = x.reshape(B * (S // token_chunk), token_chunk, d)
    outs, auxes = zip(*(_routed_core(p, xg, cfg, cap) for xg in groups))
    out = torch.stack(outs).reshape(B, S, d)
    return _add_shared(p, x, out, cfg), torch.stack(auxes).mean()


def _add_shared(p, x: torch.Tensor, out: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """The always-on shared experts, gated per token by a sigmoid read in
    f32 from the f32 gate."""
    if not cfg.moe.n_shared_experts:
        return out
    hs = swiglu(x @ p["shared_wg"].to(x.dtype), x @ p["shared_wi"].to(x.dtype))
    ys = hs @ p["shared_wo"].to(x.dtype)
    sg = torch.sigmoid(x.float() @ p["shared_gate"].float()).to(x.dtype)
    return out + sg * ys
