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

Under a mesh (``pl``, a ``dist.sharding.Placement``) every rank routes
every token from the whole router, and the experts split as
``pl.moe_split`` says: ``experts`` (expert-parallel: a rank runs only its
``pl.n_experts`` local experts; rows routed elsewhere are left out of
its sort and its buffers, never clamped to a local expert) or ``ffn``
(expert-split: every expert at ``d_expert / M`` columns). Either way a
rank's output is a partial sum, summed over ``model`` with the shared
experts' (g); the tokens and the gates enter the experts through f.
With ``rows_split`` (the forward of a train step: each batch rank, of
``pod`` x ``data``, holds its rows of the global batch) the semantics
stay global over the batch axes: the capacity counts the global T, a
(token, k) slot's position counts the slots of the lower batch ranks
first, in ``Placement.batch_index`` order (an exclusive prefix of their
per-expert counts; where the batch splits over some batch axes alone,
the ranks along the others holding the same rows, each lower block
counts once: ``Placement.row_blocks``, the axes being
``dist.sharding.row_split``'s, the reference's sanitized batch rule),
and the aux loss is formed from the global
means (``Placement.total_batch``, so its gradient enters once however
many ranks compute it; a block held by r ranks is counted r times in
both the sums and the count). A GShard token group lies inside one row, so it
never straddles batch ranks; only the groups' mean aux is global.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Sequence, Tuple

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
    sx = ("layers",) * len(stack)
    defs = {
        "router": ParamDef(stack + (d, m.n_experts),
                           axes=sx + (None, "experts")),
        "wi": ParamDef(stack + (m.n_experts, d, m.d_expert),
                       axes=sx + ("experts", "embed", "expert_ffn")),
        "wg": ParamDef(stack + (m.n_experts, d, m.d_expert),
                       axes=sx + ("experts", "embed", "expert_ffn")),
        "wo": ParamDef(stack + (m.n_experts, m.d_expert, d),
                       axes=sx + ("experts", "expert_ffn", "embed")),
    }
    if m.n_shared_experts:
        ff_sh = m.n_shared_experts * (m.d_shared_expert or m.d_expert)
        defs["shared_wi"] = ParamDef(stack + (d, ff_sh),
                                     axes=sx + ("embed", "ffn"))
        defs["shared_wg"] = ParamDef(stack + (d, ff_sh),
                                     axes=sx + ("embed", "ffn"))
        defs["shared_wo"] = ParamDef(stack + (ff_sh, d),
                                     axes=sx + ("ffn", "embed"))
        defs["shared_gate"] = ParamDef(stack + (d, 1),
                                       axes=sx + (None, None))
    return defs


def moe_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
            dropless: bool = False, token_chunk: int = 0,
            policy: Optional[KernelPolicy] = None, pl=None,
            rows_split: Tuple[str, ...] = (),
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss f32 scalar).

    ``dropless`` keeps every token (decode; serving prefill). Otherwise
    tokens over an expert's capacity are dropped, per GShard token group
    of ``token_chunk`` tokens when that divides S (0: one group). Under
    ``pl`` this rank's experts; ``rows_split`` names the batch axes
    the global batch's rows split over, x holding this rank's
    (``dist.sharding.row_split``; module docstring)."""
    m = cfg.moe
    B, S, d = x.shape
    dpl = pl if rows_split and pl is not None and pl.batch_split else None
    if dropless:
        out, aux = _routed_grouped(p, x.reshape(B * S, d), cfg, policy, pl,
                                   dpl)
        return _add_shared(p, x, out.reshape(B, S, d), cfg, pl), aux
    if token_chunk and S % token_chunk == 0 and token_chunk < S:
        return _moe_ffn_grouped(p, x, cfg, token_chunk, pl, dpl)
    T = B * S
    n_blocks, lower = dpl.row_blocks(rows_split) if dpl is not None \
        else (1, [])
    Tg = T * n_blocks
    cap = int(math.ceil(m.experts_per_token * Tg / m.n_experts
                        * m.capacity_factor))
    cap = max(m.experts_per_token, min(cap, Tg))
    out, aux = _routed_core(p, x.reshape(T, d), cfg, cap, pl, dpl, lower)
    return _add_shared(p, x, out.reshape(B, S, d), cfg, pl), aux


def _split(pl) -> Optional[str]:
    return None if pl is None else pl.moe_split


def _enter_experts(pl, xt: torch.Tensor, gate_vals: torch.Tensor):
    """The tokens and the gates as the experts read them: through f when
    the experts split (each rank's gradient carries its own experts'
    share)."""
    if _split(pl) is None:
        return xt, gate_vals
    return pl.enter_model(xt), pl.enter_model(gate_vals)


def _route(p: Dict[str, torch.Tensor], xt: torch.Tensor, cfg: ModelConfig,
           dpl=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k token-choice routing in f32, shared by every path.

    xt: (T, d) -> (gate_vals (T, K) normalised, idx (T, K) int64, aux).
    Ties go to the lower expert index, as ``jax.lax.top_k`` breaks them
    (``torch.topk`` promises no order): the first K of a stable
    descending sort. With ``dpl`` the aux loss's means are over the
    global batch (every batch rank's rows)."""
    m = cfg.moe
    E, K = m.n_experts, m.experts_per_token
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    gate_vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = gate_vals[:, :K], idx[:, :K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    # aux load-balancing loss (Switch/GShard form)
    if dpl is None:
        me = probs.mean(dim=0)                                  # (E,)
        ce = F.one_hot(idx, E).float().sum(dim=1).mean(dim=0) / K
    else:
        n = xt.shape[0] * dpl.batch_ranks
        me = dpl.total_batch(probs.sum(dim=0)) / n
        ce = dpl.mesh.all_reduce(F.one_hot(idx, E).float().sum(dim=(0, 1)),
                                 dpl.batch_axis) / n / K
    aux = E * torch.sum(me * ce) * m.router_aux_loss
    return gate_vals, idx, aux


def _routed_grouped(p, xt: torch.Tensor, cfg: ModelConfig,
                    policy: Optional[KernelPolicy], pl=None, dpl=None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless expert compute as grouped GEMMs over (token, k) rows: each
    token is repeated K times (one row per chosen expert), the three
    expert matmuls follow the policy's ``moe_gemm`` choice and the K
    outputs are gate-combined. Under ``cuda`` the three products share
    one sort by expert (the layout depends on the routing alone).
    Expert-parallel, every row stays and a row of another rank's expert
    names no expert here (``n_experts``): the products leave it out and
    its output is zero (its share is another rank's), and no shape
    depends on the routing."""
    m = cfg.moe
    T, d = xt.shape
    E, K = m.n_experts, m.experts_per_token
    gate_vals, idx, aux = _route(p, xt, cfg, dpl)
    xt, gate_vals = _enter_experts(pl, xt, gate_vals)
    x_rep = xt.repeat_interleave(K, dim=0)                      # (T*K, d)
    eor = idx.reshape(T * K).to(torch.int32)                    # row -> expert
    if _split(pl) == "experts":
        lo, E = pl.expert_start, pl.n_experts
        eor = torch.where((eor >= lo) & (eor < lo + E), eor - lo, E)
    wg, wi, wo = (p[n].to(xt.dtype) for n in ("wg", "wi", "wo"))
    if resolve_policy(policy).impl_for("moe_gemm") == "cuda":
        y = fused_call("moe_gemm_glu", moe_gemm_glu, _EXPERT_GLU_TORCH,
                       x_rep, wg, wi, wo, eor, act=swiglu, n_experts=E)
    else:
        y = _expert_glu(x_rep, wg, wi, wo, eor, act=swiglu, n_experts=E,
                        policy=policy)                          # (T*K, d)
    if _split(pl) is not None:          # a partial sum: combined in f32
        return (y.reshape(T, K, d).float()
                * gate_vals[..., None]).sum(dim=1), aux
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


def _routed_core(p, xt: torch.Tensor, cfg: ModelConfig, cap: int, pl=None,
                 dpl=None, lower: Sequence[int] = ()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bounded dispatch for one token group. xt: (T, d).

    A (token, k) slot's position in its expert's buffer is the count of
    earlier slots (token-major, then k) routed to the same expert; slots
    at positions >= ``cap`` are dropped. The reference computes those
    counts with a strictly lower-triangular matmul for small groups and
    a cumsum for large ones; both give the same exact integers, so one
    cumsum serves here. With ``dpl`` the earlier slots of the lower
    blocks count first (``lower``: their positions in the batch group,
    ``Placement.row_blocks``); expert-parallel, only this rank's
    experts' buffers are filled and run."""
    m = cfg.moe
    T, d = xt.shape
    E, K = m.n_experts, m.experts_per_token
    gate_vals, idx, aux = _route(p, xt, cfg, dpl)
    e_all = idx.reshape(T * K)
    choice = F.one_hot(e_all, E)                                # (T*K, E)
    pos_in_e = ((torch.cumsum(choice, dim=0) - choice) * choice).sum(-1)
    if dpl is not None:
        every = dpl.mesh.all_gather(choice.sum(dim=0)[None],
                                    dpl.batch_axis, 0)
        pos_in_e = pos_in_e + every[lower].sum(dim=0)[e_all]
    keep = pos_in_e < cap                                       # (T*K,)
    xt, gate_vals = _enter_experts(pl, xt, gate_vals)
    lo = 0
    if _split(pl) == "experts":
        lo, E = pl.expert_start, pl.n_experts
        keep = keep & (e_all >= lo) & (e_all < lo + E)
    tok = torch.arange(T, device=xt.device).repeat_interleave(K)[keep]
    e_k = e_all[keep] - lo
    slot = e_k * cap + pos_in_e[keep]                           # (e, c) flat

    xe = xt.new_zeros((E * cap, d))
    xe[slot] = xt[tok]
    xe = xe.reshape(E, cap, d)
    h = swiglu(torch.bmm(xe, p["wg"].to(xe.dtype)),
               torch.bmm(xe, p["wi"].to(xe.dtype)))
    ye = torch.bmm(h, p["wo"].to(h.dtype)).reshape(E * cap, d)
    acc = xt.dtype if _split(pl) is None else torch.float32  # partial: f32
    gate = gate_vals.reshape(T * K)[keep].to(acc)
    out = xt.new_zeros((T, d), dtype=acc)
    out.index_add_(0, tok, ye[slot].to(acc) * gate[:, None])
    return out, aux


def _moe_ffn_grouped(p, x: torch.Tensor, cfg: ModelConfig, token_chunk: int,
                     pl=None, dpl=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard token groups: each ``token_chunk``-token group of a row is
    dispatched on its own, with capacity ``ceil(K Tc / E * cf)``; with
    ``dpl`` the groups' mean aux is the global batch's."""
    m = cfg.moe
    B, S, d = x.shape
    K, E = m.experts_per_token, m.n_experts
    cap = int(math.ceil(K * token_chunk / E * m.capacity_factor))
    cap = max(K, min(cap, token_chunk))
    groups = x.reshape(B * (S // token_chunk), token_chunk, d)
    outs, auxes = zip(*(_routed_core(p, xg, cfg, cap, pl) for xg in groups))
    out = torch.stack(outs).reshape(B, S, d)
    aux = torch.stack(auxes).mean()
    if dpl is not None:
        aux = dpl.total_batch(aux) / dpl.batch_ranks
    return _add_shared(p, x, out, cfg, pl), aux


def _add_shared(p, x: torch.Tensor, out: torch.Tensor, cfg: ModelConfig,
                pl=None) -> torch.Tensor:
    """The always-on shared experts, gated per token by a sigmoid read in
    f32 from the f32 gate, added to the routed ``out``. On a mesh each
    part that splits is a partial sum taken in f32 (the routed ``out``
    comes so), rounded once after the sum over ``model``; one sum
    completes both when both split."""
    routed = _split(pl) is not None
    shared = pl is not None and pl.shared_split
    if not cfg.moe.n_shared_experts:
        return pl.reduce_model(out).to(x.dtype) if routed else out
    xs = pl.enter_model(x) if shared else x
    hs = swiglu(xs @ p["shared_wg"].to(x.dtype),
                xs @ p["shared_wi"].to(x.dtype))
    sg = torch.sigmoid(x.float() @ p["shared_gate"].float()).to(x.dtype)
    if not shared:
        ys = hs @ p["shared_wo"].to(x.dtype)
        return (pl.reduce_model(out).to(x.dtype) if routed else out) \
            + sg * ys
    ys = hs.float() @ p["shared_wo"].float()             # a partial sum
    if routed:
        return pl.reduce_model(out + pl.enter_model(sg).float() * ys).to(
            x.dtype)
    return out + sg * pl.reduce_model(ys).to(x.dtype)
