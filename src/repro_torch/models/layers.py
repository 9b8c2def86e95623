"""Shared model primitives of the port: parameter definitions, RMSNorm
and LayerNorm, RoPE (standard, partial, 2d and M-RoPE), the activations
and the cross-entropy loss (counterpart of ``repro.models.layers``).

Parameter *definitions* (shape + initializer) are data, so ``init`` and
the shape checks of the weight bridge derive from one source.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.dispatch import RMSNORM_EPS, KernelPolicy, dispatch


# ===========================================================================
# Parameter definition table
# ===========================================================================
@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "fan_in"                # fan_in | embed | zeros | ones | const
    scale: float = 1.0                  # std multiplier; the value of const


DefTree = Union[ParamDef, Dict[str, "DefTree"]]


def _leaf_seed(seed: int, path: str) -> int:
    """Per-leaf seed from the leaf's tree path: stable across processes
    (``hash()`` is salted per interpreter run)."""
    return (int(seed) * 1_000_003 + zlib.crc32(path.encode())) % (2 ** 63)


def init_from_defs(defs: DefTree, seed: int, device, path: str = "",
                   cast: Optional[Callable] = None):
    """f32 master weights with the reference's distributions: ``embed``
    is N(0, (0.02 scale)^2), ``fan_in`` a normal truncated at two
    standard deviations with std ``scale / sqrt(fan_in)``, ``const`` the
    value ``scale``. Each leaf draws from its own ``torch.Generator``
    seeded from ``(seed, path)``; the values differ from ``jax.random``'s,
    which the weight bridge (``models.convert``) exists for.

    ``cast(path, leaf)``, when given, maps each leaf right after it is
    drawn, so a tree cast to a narrower dtype never holds every f32
    master at once."""
    if isinstance(defs, dict):
        return {k: init_from_defs(v, seed, device, f"{path}['{k}']", cast)
                for k, v in defs.items()}
    out = _init_leaf(defs, seed, device, path)
    return out if cast is None else cast(path, out)


def _init_leaf(d: ParamDef, seed: int, device, path: str) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, device=device)
    if d.init == "const":
        return torch.full(d.shape, float(d.scale), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_leaf_seed(seed, path))
    out = torch.empty(d.shape, device=device)
    if d.init == "embed":
        return out.normal_(0.0, 0.02 * d.scale, generator=gen)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    std = d.scale / math.sqrt(max(1, fan_in))
    return torch.nn.init.trunc_normal_(out, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=gen)


# ===========================================================================
# Norms (compute in f32, cast back)
# ===========================================================================
def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = RMSNORM_EPS,
            policy: Optional[KernelPolicy] = None) -> torch.Tensor:
    """RMSNorm through the kernel dispatch layer; ``eps`` threads into
    whichever implementation runs."""
    return dispatch("rmsnorm", policy, x, scale, eps=eps)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm as the reference computes it: in f32, the population
    variance, f32 scale and bias, cast back to x's dtype. No Pallas
    kernel computes it, so these plain ops are its port."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def norm(x: torch.Tensor, p: Dict[str, torch.Tensor], kind: str,
         policy: Optional[KernelPolicy] = None) -> torch.Tensor:
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"], policy=policy)


def norm_defs(d_model: int, kind: str) -> Dict[str, ParamDef]:
    out = {"scale": ParamDef((d_model,), "ones")}
    if kind == "layernorm":
        out["bias"] = ParamDef((d_model,), "zeros")
    return out


# ===========================================================================
# RoPE (standard / partial / 2d / M-RoPE)
# ===========================================================================
def rotary_dims(cfg: ModelConfig) -> int:
    rot = int(cfg.head_dim * cfg.partial_rotary)
    return rot - (rot % 2)


def _rope_cos_sin(positions: torch.Tensor, rot: int, theta: float,
                  sections: Tuple[int, ...] = ()
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (B, S, rot/2) in f32. ``positions`` is (B, S), or
    (3, B, S) for M-RoPE, whose leading axis is (temporal, height,
    width) and whose ``sections`` give each component's count of
    frequency pairs; a (3, B, S) position fed to a model without M-RoPE
    takes component 0, as the reference does."""
    half = rot // 2
    expo = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv_freq = 1.0 / (theta ** expo)
    if sections:
        if positions.dim() != 3 or sum(sections) != half:
            raise ValueError(f"M-RoPE needs (3, B, S) positions and "
                             f"sections summing to {half}; got "
                             f"{tuple(positions.shape)}, {sections}")
        parts, start = [], 0
        for comp, sec in enumerate(sections):
            parts.append(positions[comp][..., None].float()
                         * inv_freq[start:start + sec])
            start += sec
        freqs = torch.cat(parts, dim=-1)
    else:
        if positions.dim() == 3:     # text fed to an M-RoPE-less model
            positions = positions[0]
        freqs = positions[..., None].float() * inv_freq
    return torch.cos(freqs), torch.sin(freqs)


def rope_tables(positions: torch.Tensor, cfg: ModelConfig
                ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """cos/sin for ``positions`` ((B, S), or (3, B, S) for M-RoPE),
    shaped to broadcast over heads; computed once per forward or decode
    step and shared by every layer. ``2d`` (ChatGLM) is the standard
    rotation over the first ``partial_rotary`` of each head, as the
    reference computes it."""
    if cfg.rope == "none":
        return None
    sections = cfg.mrope_sections if cfg.rope == "mrope" else ()
    cos, sin = _rope_cos_sin(positions, rotary_dims(cfg), cfg.rope_theta,
                             sections)
    return cos[:, :, None, :], sin[:, :, None, :]


def apply_rope(q: torch.Tensor, k: torch.Tensor, tables, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: (B, S, Hq, hd), k: (B, S, Hkv, hd); ``tables`` from
    :func:`rope_tables`. The rotation runs in f32, cast back per half."""
    if tables is None:
        return q, k
    cos, sin = tables
    rot = rotary_dims(cfg)

    def rotate(x):
        xr, xp = x[..., :rot], x[..., rot:]
        x1, x2 = xr.chunk(2, dim=-1)
        out1 = x1 * cos - x2 * sin
        out2 = x2 * cos + x1 * sin
        return torch.cat([out1.to(x.dtype), out2.to(x.dtype), xp], dim=-1)

    return rotate(q), rotate(k)


# ===========================================================================
# Activations + loss
# ===========================================================================
def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``jax.nn.gelu``, whose default is the tanh
    approximation (``F.gelu``'s default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; logits promoted to f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)
