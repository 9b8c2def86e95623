"""Split-KV decode attention: the kernel's wrapper and its plain version.

Replaces ``src/repro/kernels/decode_attention.py``
``decode_attention_splitkv``. The kernel (``csrc/decode_attention.cu``)
is the row-parallel split body of ``csrc/splitkv.cuh``: each 128-row
split of the cache is reduced into f32 ``(o, m, l)`` partials, ``D / 8``
lanes a bf16 row (rounded up to a power of two: 16 at D 80, 6 idle; 32
at D 160, 12 idle) with one 16-byte load each of K and V (at G 1), and
a second small kernel merges them with LSE weights. See the sources for
what bounds it and the design. The helpers below validate and allocate
for every split-KV wrapper (contiguous, paged, int8, int8 paged), all
four on that one body and merge.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import plan as P
from repro_torch.kernels.dispatch import meta_launch

NEG_INF = -1e30

#: Logical cache rows per split (threads per block of the split kernel).
BLOCK_K = 128
#: Head dims the kernel is instantiated for (80: zamba2-2.7b; 160:
#: stablelm-12b), and the largest GQA group (16: chatglm3-6b; past 8 the
#: query heads of a kv head split over blocks of at most 8).
HEAD_DIMS = (16, 32, 64, 80, 128, 160)
MAX_GROUP = 16


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           kv_mask: torch.Tensor) -> torch.Tensor:
    """One-token decode in f32, the reference ``xla`` implementation op
    for op. q: (B, Hq, D); caches: (B, W, Hkv, D); kv_mask: (B, W)."""
    B, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bwhd->bhgw", qg, k_cache.float()) / math.sqrt(D)
    s = torch.where(kv_mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgw,bwhd->bhgd", p, v_cache.float())
    return out.reshape(B, Hq, D).to(q.dtype)


def check_query(op: str, q: torch.Tensor, Hkv: int) -> int:
    """Validate the (B, Hq, D) query of a split-KV kernel; returns its
    dtype code."""
    if q.device.type not in _build.KERNEL_DEVICES:
        raise ValueError(f"{op}: tensors on {q.device}")
    if q.dim() != 3:
        raise ValueError(f"{op}: q must be (B, Hq, D), got "
                         f"{tuple(q.shape)}")
    Hq, D = q.shape[1], q.shape[2]
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"{op}: Hq={Hq}, Hkv={Hkv}: the group must divide "
                         f"and be <= {MAX_GROUP}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{op}: head dim {D} not in {HEAD_DIMS}")
    if not q.is_contiguous():
        raise ValueError(f"{op}: q must be contiguous")
    return _build.dtype_code(q)


def check_input(op: str, name: str, t: torch.Tensor, shape: Sequence[int],
                dtype: torch.dtype, device: torch.device,
                aligned: bool = False) -> None:
    """One kernel input: device, dtype, shape, contiguity and (for rows
    read with vector loads) 16-byte alignment."""
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{op}: {name} is {t.dtype} on {t.device}, "
                         f"expected {dtype} on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} shape {tuple(t.shape)} != "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{op}: {name} is not 16-byte aligned")


def splitkv_buffers(q: torch.Tensor, Hkv: int, W: int):
    """f32 split partials ``o (B*Hkv, ns, G, D)``, ``(m, l)`` stacked, and
    the output, for ``W`` logical rows."""
    B, Hq, D = q.shape
    G = Hq // Hkv
    ns = -(-W // BLOCK_K)
    o_part = torch.empty((B * Hkv, ns, G, D), dtype=torch.float32,
                         device=q.device)
    ml = torch.empty((2, B * Hkv, ns, G), dtype=torch.float32,
                     device=q.device)
    return o_part, ml, torch.empty_like(q)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     kv_mask: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors; the plain version for CPU tensors;
    on ``meta`` the checks, the buffers and an empty output."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_mask)
    op = "decode_attention"
    B, Hq, D = q.shape
    W, Hkv = k_cache.shape[1], k_cache.shape[2]
    code = check_query(op, q, Hkv)
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        check_input(op, name, t, (B, W, Hkv, D), q.dtype, q.device,
                    aligned=True)
    check_input(op, "kv_mask", kv_mask, (B, W), torch.bool, q.device)
    o_part, ml, out = splitkv_buffers(q, Hkv, W)
    if q.device.type == "meta":
        return meta_launch(op, out)
    err = _build.library().rt_decode_attention(
        _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
        _build.ptr(kv_mask), _build.ptr(o_part), _build.ptr(ml[0]),
        _build.ptr(ml[1]), _build.ptr(out), B, W, Hkv, Hq // Hkv, D, code,
        _build.stream_handle())
    _build.check_launch(err, op)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

#: Query heads a block of the split kernel computes at most.
MAXG = 8


def splitkv_plan(family: str, B: int, W: int, Hkv: int, G: int, D: int,
                 dtype: torch.dtype, *, paged: bool) -> P.KernelPlan:
    """The two launches of a split-KV call (``csrc/splitkv.cuh``
    ``dispatch``), for q (B, Hkv * G, D) of ``dtype`` over ``W`` logical
    rows: the split kernel ``family`` (``split_rows_kernel`` or
    ``quant_split_kernel``), one block of :data:`BLOCK_K` threads per
    (b * Hkv + hk, split of BLOCK_K rows, part of the group of at most 8
    heads), writing its ``o``, ``m`` and ``l`` partials; then the merge,
    one block of D threads per (b * Hkv + hk, query head), writing the
    output. Raises where the wrappers refuse."""
    tn = P.type_name(dtype)
    Hq = Hkv * G
    if G < 1 or G > MAX_GROUP:
        raise ValueError(f"{family}: Hq={Hq}, Hkv={Hkv}: the group must "
                         f"divide and be <= {MAX_GROUP}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{family}: head dim {D} not in {HEAD_DIMS}")
    results = (((B, Hq, D), dtype),)
    if B <= 0 or W <= 0:
        return P.KernelPlan((), results)
    ngrp = P.cdiv(G, MAXG)
    GB = P.cdiv(G, ngrp)
    NG = 1 if GB == 1 else 2 if GB == 2 else 4 if GB <= 4 else 8
    ns = P.cdiv(W, BLOCK_K)
    BH = B * Hkv

    def parts(bx, by, bz):
        return [(bx, by, bz, np.zeros_like(bx))]

    def stats(bx, by, bz):
        return [(bx, by, bz)]

    split = P.Launch(
        f"{family}<{tn},{D},{NG},{'paged' if paged else 'contiguous'}>",
        P.grid3(BH, ns, ngrp), P.grid3(BLOCK_K),
        # srow (BK long longs), sp (NG x BK), red (NG x 4 warps) and so
        # (4 warps x NG x D) floats
        8 * BLOCK_K + 4 * NG * BLOCK_K + 16 * NG + 16 * NG * D, 0,
        (P.Output("o_part", (BH, ns, G, D), torch.float32, (1, 1, GB, D),
                  parts),
         P.Output("m_part", (BH, ns, G), torch.float32, (1, 1, GB), stats),
         P.Output("l_part", (BH, ns, G), torch.float32, (1, 1, GB), stats)))
    merge = P.Launch(
        f"merge_kernel<{tn}>", P.grid3(BH, G), P.grid3(D), 0, 0,
        (P.Output("out", (B, Hq, D), dtype, (1, 1, D),
                  lambda bx, by, bz: [(bx, by, np.zeros_like(bx))],
                  view=(BH, G, D)),))
    return P.KernelPlan((split, merge), results)


def launch_plan(B: int, W: int, Hq: int, Hkv: int, D: int,
                dtype: torch.dtype) -> P.KernelPlan:
    """What :func:`decode_attention` launches for q (B, Hq, D) over a
    (B, W, Hkv, D) cache of ``dtype``."""
    _check_group("decode_attention", Hq, Hkv)
    return splitkv_plan("split_rows_kernel", B, W, Hkv, Hq // Hkv, D, dtype,
                        paged=False)


def library_plan(B: int, W: int, Hq: int, Hkv: int, D: int,
                 dtype: torch.dtype):
    """The library's plan of the same call (``rt_decode_attention_plan``)."""
    return P.library_plan("rt_decode_attention_plan", B, W, Hkv, Hq // Hkv,
                          D, P.dtype_code(dtype))


def _check_group(op: str, Hq: int, Hkv: int) -> None:
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"{op}: Hq={Hq}, Hkv={Hkv}: the group must divide "
                         f"and be <= {MAX_GROUP}")
