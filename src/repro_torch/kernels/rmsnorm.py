"""RMSNorm: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``src/repro/kernels/rmsnorm.py`` ``rmsnorm_pallas``. The kernel
(``csrc/rmsnorm.cu``) is bound by bytes: a row in registers, read once
and written once, and summed in the order PyTorch's own reduction sums
the plain version's ``x.float().square().mean(-1)`` on the card, so a
row's bits depend on the call's row count as the plain version's do.
See the source for the design.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import plan as P
from repro_torch.kernels.dispatch import RMSNORM_EPS, meta_launch

#: The PyTorch release whose CUDA reduction order (ATen ``Reduce.cuh``:
#: threads a row from the row count, 4 accumulators, the trees, the
#: mean's factor) ``csrc/rmsnorm.cu`` copies. With it the kernel equals
#: ``rmsnorm_plain`` bit for bit on the card; with another release it
#: is held to the one-ulp bar only (the card tests check the release).
REDUCE_ORDER_TORCH = "2.11."


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
    """The kernel for CUDA tensors; the plain version for CPU tensors;
    on ``meta`` the checks and an empty output (``meta_launch``)."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, scale, eps=eps)
    d = x.shape[-1]
    if x.device.type not in _build.KERNEL_DEVICES \
            or scale.device != x.device:
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
    if x.device.type == "meta":
        return meta_launch("rmsnorm", out)
    lib = _build.library()
    err = lib.rt_rmsnorm(_build.ptr(x), _build.ptr(scale), _build.ptr(out),
                         x.numel() // d if d else 0, d, float(eps), code,
                         _build.stream_handle())
    _build.check_launch(err, "rmsnorm")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0

#: Vectors of 4 a thread the register body holds, and threads a row.
MAX_VPL, MAX_TPR = 32, 512


def launch_plan(shape: Sequence[int], dtype: torch.dtype, *,
                scale_shape: Sequence[int] = None,
                scale_aligned: bool = True) -> P.KernelPlan:
    """What :func:`rmsnorm` launches for ``x`` of ``shape`` and
    ``dtype`` (``csrc/rmsnorm.cu`` ``dispatch``): the register body
    (``rmsnorm_vec``, or ``rmsnorm_wide`` past 32 vectors a thread) with
    PyTorch's threads a row, ``max(256, tpr) / tpr`` rows a block, or the
    scalar body, one row a block. ``scale_aligned``: the f32 scale is
    16-byte aligned, as the wrapper's copy is."""
    shape = tuple(int(n) for n in shape)
    tn = P.type_name(dtype)
    d = shape[-1]
    if scale_shape is not None and tuple(scale_shape) != (d,):
        raise ValueError(f"rmsnorm: scale shape {tuple(scale_shape)} != "
                         f"({d},)")
    rows = int(np.prod(shape[:-1], dtype=np.int64)) if d else 0
    if rows <= 0:
        return P.KernelPlan((), ((shape, dtype),))
    nvec = d // 4
    height = P.last_pow2(rows) if rows < 16 else 16
    width0 = P.last_pow2(max(nvec, 1)) if nvec < MAX_TPR else MAX_TPR
    tpr = min(width0, MAX_TPR // height)
    vpl = P.cdiv(nvec, tpr)
    split_at = min(16 * height, 256)
    if (d % 4 == 0 and d >= 128 and tpr >= 32 and P.cdiv(d, tpr) < split_at
            and scale_aligned):
        threads = max(tpr, 256)
        rpb = threads // tpr
        if vpl > MAX_VPL:
            name = f"rmsnorm_wide<{tn},{tpr}>"
        else:
            bucket = next(b for b in (1, 2, 4, 8, 16, 32) if vpl <= b)
            name = f"rmsnorm_vec<{tn},{tpr},{bucket}>"
        # part (a float a thread; a row of one warp sums by shuffles and
        # the compiler drops it) and total (a float a row)
        grid = P.cdiv(rows, rpb)
        static = 4 * rpb + (4 * threads if tpr > 32 else 0)
    else:
        threads = 256 if d >= 2048 else (128 if d >= 512 else 32)
        name, rpb, grid, static = f"rmsnorm_scalar<{tn}>", 1, rows, 128
    out = P.Output("out", shape, dtype, (rpb, d),
                   lambda bx, by, bz: [(bx, np.zeros_like(bx))],
                   view=(rows, d))
    return P.KernelPlan((P.Launch(name, P.grid3(grid), P.grid3(threads),
                                  static, 0, (out,)),),
                        ((shape, dtype),))


def library_plan(shape: Sequence[int], dtype: torch.dtype, *,
                 scale_shape: Sequence[int] = None,
                 scale_aligned: bool = True):
    """The library's plan of the same call (``rt_rmsnorm_plan``)."""
    d = int(shape[-1])
    rows = int(np.prod(shape[:-1], dtype=np.int64)) if d else 0
    return P.library_plan("rt_rmsnorm_plan", rows, d, P.dtype_code(dtype),
                          int(scale_aligned))
