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

import torch

from repro_torch.kernels import _build

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
    if q.device.type != "cuda":
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
    """The kernel for CUDA tensors; the plain version for CPU tensors."""
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
    err = _build.library().rt_decode_attention(
        _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
        _build.ptr(kv_mask), _build.ptr(o_part), _build.ptr(ml[0]),
        _build.ptr(ml[1]), _build.ptr(out), B, W, Hkv, Hq // Hkv, D, code,
        _build.stream_handle())
    _build.check_launch(err, op)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
