"""Mamba-2 (SSD) mixer of the port (counterpart of ``repro.models.ssm``).

Prefill runs the chunked SSD scan through the ``ssd_scan`` dispatch op
(the CUDA kernel on the card, ``kernels.ssd_scan.ssd_chunked`` as its
plain version); decode is the plain recurrence on the carried state, in
plain PyTorch as in the reference, which has no kernel there either.

Under a mesh (``pl``, a ``dist.sharding.Placement`` with ``ssm_split``)
the mixer is head-aligned: a rank holds its own SSD heads' z, x and dt
columns of ``in_proj``, their conv channels, ``A_log``/``D``/``dt_bias``,
``norm`` and ``out_proj`` rows and their state, with B and C (one
group) whole, and
runs the scan on its heads alone (``nh / M`` of them). The normed input
enters through f; the gated RMSNorm spans all of ``d_inner``, so its sum
of squares is summed over ``model`` (``Placement.total_model``, whose
backward sums too) and the split form runs in place of the RMSNorm
kernel, which normalises whole rows; ``out_proj``'s partial products are
summed over ``model`` (g) in f32 (``layers.row_parallel``). Under
autograd B/C's columns and channels enter through an f over ``model``:
each rank's copy gets gradient only from its own heads.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import RMSNORM_EPS, KernelPolicy, dispatch
from repro_torch.models.layers import ParamDef, rmsnorm, row_parallel


def ssm_dims(cfg: ModelConfig) -> Dict[str, int]:
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    conv_dim = di + 2 * s.n_groups * s.d_state
    proj_dim = 2 * di + 2 * s.n_groups * s.d_state + nh
    return dict(di=di, nh=nh, hp=s.head_dim, g=s.n_groups, N=s.d_state,
                conv_dim=conv_dim, proj_dim=proj_dim, d_conv=s.d_conv)


def ssm_defs(cfg: ModelConfig, stack: Tuple[int, ...] = ()) -> Dict:
    dims = ssm_dims(cfg)
    d = cfg.d_model
    sx = ("layers",) * len(stack)
    return {
        "in_proj": ParamDef(stack + (d, dims["proj_dim"]),
                            axes=sx + ("embed", "ssm_inner")),
        "conv_w": ParamDef(stack + (dims["d_conv"], dims["conv_dim"]),
                           "fan_in", 1.0, axes=sx + (None, "ssm_inner")),
        "conv_b": ParamDef(stack + (dims["conv_dim"],), "zeros",
                           axes=sx + ("ssm_inner",)),
        "A_log": ParamDef(stack + (dims["nh"],), "const", 0.0,  # A = -1
                          axes=sx + ("ssm_heads",)),
        "D": ParamDef(stack + (dims["nh"],), "ones",
                      axes=sx + ("ssm_heads",)),
        "dt_bias": ParamDef(stack + (dims["nh"],), "zeros",
                            axes=sx + ("ssm_heads",)),
        "norm": ParamDef(stack + (dims["di"],), "ones",
                         axes=sx + ("ssm_inner",)),
        "out_proj": ParamDef(stack + (dims["di"], d),
                             axes=sx + ("ssm_inner", "embed")),
    }


def _split(pl) -> bool:
    return pl is not None and pl.ssm_split


def _local_dims(dims: Dict[str, int], pl) -> Dict[str, int]:
    """:func:`ssm_dims` at this rank's heads (one device, or a mixer
    whole on every rank: ``dims``); B and C, of one group, whole."""
    if not _split(pl):
        return dims
    nh, N = pl.ssm_heads, dims["N"]
    di = nh * dims["hp"]
    return dict(dims, di=di, nh=nh, conv_dim=di + 2 * N,
                proj_dim=2 * di + 2 * N + nh)


def _mixer_weights(p, dims: Dict[str, int], pl):
    """``in_proj``, ``conv_w`` and ``conv_b`` as the mixer reads them:
    under autograd on a mesh, B/C's columns and channels (every rank's
    copy) entered through f over ``model``."""
    w, cw, cb = p["in_proj"], p["conv_w"], p["conv_b"]
    if not (_split(pl) and torch.is_grad_enabled()):
        return w, cw, cb
    di, bc = dims["di"], 2 * dims["N"]

    def enter(t, lo):
        return torch.cat([t[..., :lo], pl.enter_model(t[..., lo:lo + bc]),
                          t[..., lo + bc:]], dim=-1)

    return enter(w, 2 * di), enter(cw, di), enter(cb, di)


def _gated_norm(u: torch.Tensor, scale: torch.Tensor, d_inner: int,
                policy, pl) -> torch.Tensor:
    """RMSNorm of the gated output over all of ``d_inner``: the kernel on
    a whole row; on a mesh the split form, each rank's sum of squares
    summed over ``model``."""
    if not _split(pl):
        return rmsnorm(u, scale, policy=policy)
    uf = u.float()
    var = pl.total_model(uf.square().sum(dim=-1, keepdim=True)) / d_inner
    return (uf * torch.rsqrt(var + RMSNORM_EPS) * scale.float()).to(u.dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, S, C); w: (K, C); returns (y, the
    last K-1 inputs as the new state)."""
    K = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[-1]))
    xe = torch.cat([state.to(x.dtype), x], dim=1)
    y = torch.zeros_like(x)
    for i in range(K):
        y = y + xe[:, i:i + x.shape[1]] * w[i].to(x.dtype)
    new_state = xe[:, -(K - 1):] if K > 1 else state
    return y + b.to(x.dtype), new_state


def _split_heads(xBC: torch.Tensor, dims, lead: Tuple[int, ...]):
    """xBC (..., conv_dim) -> x (..., nh, hp) and B, C (..., nh, N), each
    contiguous (the kernel takes no strided views), groups repeated
    over their heads."""
    di, nh, hp, g, N = (dims[k] for k in ("di", "nh", "hp", "g", "N"))
    xs, Bm, Cm = torch.split(xBC, [di, g * N, g * N], dim=-1)
    rep = nh // g
    Bm = Bm.reshape(lead + (g, N)).repeat_interleave(rep, dim=-2)
    Cm = Cm.reshape(lead + (g, N)).repeat_interleave(rep, dim=-2)
    return xs.reshape(lead + (nh, hp)).contiguous(), Bm, Cm


def _dt_A(p, dt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """softplus(dt + dt_bias) and A = -exp(A_log), in f32 from the f32
    masters."""
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["A_log"].float())


def ssm_block(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              policy: Optional[KernelPolicy] = None, pl=None,
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full Mamba-2 mixer for prefill. x: (B, S, d) -> (B, S, d), and the
    final recurrent state {'conv', 'ssm'} for the decode handoff (this
    rank's heads under ``pl``)."""
    dims = _local_dims(ssm_dims(cfg), pl)
    di, nh = dims["di"], dims["nh"]
    B_, S, _ = x.shape
    if _split(pl):
        x = pl.enter_model(x)
    w, cw, cb = _mixer_weights(p, dims, pl)
    zxbcdt = x @ w.to(x.dtype)
    z, xBC_raw, dt = torch.split(zxbcdt, [di, dims["conv_dim"], nh], dim=-1)
    xBC, conv_state = _causal_conv(xBC_raw, cw, cb)
    xs, Bm, Cm = _split_heads(F.silu(xBC), dims, (B_, S))
    dt, A = _dt_A(p, dt)
    y, h_final = dispatch("ssd_scan", policy, xs, dt.contiguous(), A, Bm,
                          Cm, chunk=cfg.ssm.chunk_size)
    y = y + xs * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B_, S, di)
    y = _gated_norm(y * F.silu(z), p["norm"], ssm_dims(cfg)["di"], policy,
                    pl)
    out = row_parallel(y, p["out_proj"], pl if _split(pl) else None)
    return out, {"conv": conv_state, "ssm": h_final}


def ssm_cache_shapes(cfg: ModelConfig, batch: int) -> Dict[str, Tuple]:
    dims = ssm_dims(cfg)
    return {
        "conv": (batch, dims["d_conv"] - 1, dims["conv_dim"]),
        "ssm": (batch, dims["nh"], dims["hp"], dims["N"]),
    }


def ssm_decode_step(p: Dict[str, torch.Tensor], x: torch.Tensor,
                    cache: Dict[str, torch.Tensor], cfg: ModelConfig,
                    policy: Optional[KernelPolicy] = None, pl=None,
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, d) one token; cache {'conv', 'ssm'} -> (y (B, d), the new
    state, cast to the cache's dtypes; this rank's heads under ``pl``)."""
    dims = _local_dims(ssm_dims(cfg), pl)
    di, nh = dims["di"], dims["nh"]
    B_ = x.shape[0]
    if _split(pl):
        x = pl.enter_model(x)
    w, cw, cb = _mixer_weights(p, dims, pl)
    zxbcdt = x @ w.to(x.dtype)
    z, xBC, dt = torch.split(zxbcdt, [di, dims["conv_dim"], nh], dim=-1)
    xBC, conv_state = _causal_conv(xBC[:, None, :], cw, cb,
                                   state=cache["conv"])
    xs, Bm, Cm = _split_heads(F.silu(xBC[:, 0]), dims, (B_,))
    dt, A = _dt_A(p, dt)                                       # (B, nh)
    h = cache["ssm"].float()                                   # (B,nh,hp,N)
    h = h * torch.exp(dt * A)[..., None, None] + torch.einsum(
        "bhn,bhp,bh->bhpn", Bm.float(), xs.float(), dt)
    y = torch.einsum("bhn,bhpn->bhp", Cm.float(), h)
    y = y.to(x.dtype) + xs * p["D"].to(x.dtype)[None, :, None]
    y = _gated_norm(y.reshape(B_, di) * F.silu(z), p["norm"],
                    ssm_dims(cfg)["di"], policy, pl)
    out = row_parallel(y, p["out_proj"], pl if _split(pl) else None)
    return out, {"conv": conv_state.to(cache["conv"].dtype),
                 "ssm": h.to(cache["ssm"].dtype)}
