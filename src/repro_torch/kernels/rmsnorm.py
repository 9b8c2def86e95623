"""RMSNorm: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``src/repro/kernels/rmsnorm.py`` ``rmsnorm_pallas``. The kernel
(``csrc/rmsnorm.cu``) is bound by bytes: one block per row, an f32
warp-shuffle reduction, cast on write. See the source for the design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.dispatch import RMSNORM_EPS


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = RMSNORM_EPS) -> torch.Tensor:
    """x: (..., d); scale: (d,). f32 mean of squares, cast back to x's
    dtype — the reference ``xla`` implementation, op for op."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = RMSNORM_EPS) -> torch.Tensor:
    """The kernel for CUDA tensors; the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps=eps)
    d = x.shape[-1]
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm: x on {x.device}, scale on "
                         f"{scale.device}; both must be on one CUDA device")
    if not x.is_contiguous():
        raise ValueError("rmsnorm: x must be contiguous")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"rmsnorm: scale shape {tuple(scale.shape)} != "
                         f"({d},)")
    code = _build.dtype_code(x)
    scale = scale.float().contiguous()
    out = torch.empty_like(x)
    lib = _build.library()
    err = lib.rt_rmsnorm(_build.ptr(x), _build.ptr(scale), _build.ptr(out),
                         x.numel() // d if d else 0, d, float(eps), code,
                         _build.stream_handle())
    _build.check_launch(err, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
