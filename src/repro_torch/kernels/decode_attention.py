"""Split-KV decode attention: the kernel's wrapper and its plain version.

Replaces ``src/repro/kernels/decode_attention.py``
``decode_attention_splitkv``. The kernel (``csrc/decode_attention.cu``)
reduces each 128-row split of the cache into f32 ``(o, m, l)`` partials
and merges them with LSE weights in a second small kernel. See the
source for what bounds it and the design.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

#: Cache rows per split (threads per block of the split kernel).
BLOCK_K = 128
#: Head dims the kernel is instantiated for, and the largest GQA group.
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 8


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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     kv_mask: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors; the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_mask)
    B, Hq, D = q.shape
    W, Hkv = k_cache.shape[1], k_cache.shape[2]
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: tensors on {q.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"decode_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
        if tuple(t.shape) != (B, W, Hkv, D):
            raise ValueError(f"decode_attention: {name} shape "
                             f"{tuple(t.shape)} != {(B, W, Hkv, D)}")
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} is not 16-byte "
                             f"aligned")
    if kv_mask.dtype != torch.bool or tuple(kv_mask.shape) != (B, W) \
            or kv_mask.device != q.device:
        raise ValueError(f"decode_attention: kv_mask must be a ({B}, {W}) "
                         f"bool tensor on {q.device}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: Hq={Hq}, Hkv={Hkv}: the group "
                         f"must divide and be <= {MAX_GROUP}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if not all(t.is_contiguous() for t in (q, k_cache, v_cache, kv_mask)):
        raise ValueError("decode_attention: inputs must be contiguous")
    G = Hq // Hkv
    ns = -(-W // BLOCK_K)
    code = _build.dtype_code(q)
    o_part = torch.empty((B * Hkv, ns, G, D), dtype=torch.float32,
                         device=q.device)
    ml = torch.empty((2, B * Hkv, ns, G), dtype=torch.float32,
                     device=q.device)
    out = torch.empty_like(q)
    lib = _build.library()
    err = lib.rt_decode_attention(
        _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
        _build.ptr(kv_mask), _build.ptr(o_part), _build.ptr(ml[0]),
        _build.ptr(ml[1]), _build.ptr(out), B, W, Hkv, G, D, code,
        _build.stream_handle())
    _build.check_launch(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
