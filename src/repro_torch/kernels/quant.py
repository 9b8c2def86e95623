"""int8 weights and the int8 KV cache: the quantization schemes, the
int8-weight matmul and the int8 split-KV decode kernels' wrappers with
their plain versions.

Replaces ``src/repro/kernels/quant.py``: ``quantize_rows`` /
``dequantize_rows`` / ``quantize_channels``, the int8-weight matmul
``quant_matmul_pallas`` (``csrc/quant_matmul.cu``) and the two KV
kernels, ``quant_decode_attention_splitkv`` (contiguous) and
``quant_paged_decode_attention_splitkv`` (paged), both in
``csrc/quant_attention.cu``: the row-parallel split body of
``csrc/splitkv.cuh`` over an int8 cache, ``D / 16`` lanes a cache row
with one 16-byte load each of K and V (at G 1), and its merge kernel.
See the sources for what bounds them and the design.

Schemes (the reference's): each (token, kv head) row of D values gets one
symmetric scale ``absmax / 127``, stored bf16 in the ``ks``/``vs``
side-bands; rows quantize once, at write time, and dequantize as
``q.float() * scale.float()``. A ``(K, N)`` weight gets one f32 scale per
output column.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import (check_input, check_query,
                                                  decode_attention_plain,
                                                  splitkv_buffers)
from repro_torch.kernels.paged_attention import gather_pages

#: Declared tolerance for the max abs logit deviation of the int8-KV
#: path against bf16 KV (the reference's ``QUANT_PARITY_TOL``).
QUANT_PARITY_TOL = 0.25

#: float32(1/127). The reference writes ``absmax / 127.0``, but it runs
#: under ``jax.jit`` on every serving path, where XLA turns the division
#: by a constant into a multiply by its f32 reciprocal; the two differ in
#: the last bit of some scales, and so in some payloads. The port
#: multiplies, as the jitted reference computes.
INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


def quantize_rows(x: torch.Tensor, scale_dtype: torch.dtype = torch.bfloat16):
    """Per-row symmetric int8 over the last axis: x (..., D) float ->
    (q int8 (..., D), scale ``scale_dtype`` (...)). All-zero rows get
    scale 0 and payload 0; rounding is half to even."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) * INV_127
    inv = torch.where(scale > 0, 1.0 / torch.clamp(scale, min=1e-30),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(xf * inv[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(scale_dtype)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` -> float32 (..., D)."""
    return q.float() * scale.float()[..., None]


def quantize_channels(w: torch.Tensor):
    """Per-output-channel symmetric int8 for a (K, N) weight -> (w_q int8
    (K, N), scale float32 (N,)). Unlike :func:`quantize_rows` this
    divides by 127, as the reference computes it at its only call site
    (the tuner's inputs, built eagerly, not under ``jit``)."""
    wf = w.float()
    scale = wf.abs().amax(dim=0) / 127.0
    inv = torch.where(scale > 0, 1.0 / torch.clamp(scale, min=1e-30),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(wf * inv[None, :]), -127, 127)
    return q.to(torch.int8), scale


def quant_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """x (T, K) float; w_q (K, N) int8; scale (N,) -> (T, N) in x's
    dtype: the f32 product times the scale, rounded once (the reference
    ``quant_matmul_xla``)."""
    acc = x.float() @ w_q.float()
    return (acc * scale.float()[None, :]).to(x.dtype)


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """The kernel for CUDA tensors; the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_q, scale)
    op = "quant_matmul"
    if x.device.type != "cuda" or x.dim() != 2:
        raise ValueError(f"{op}: x must be a (T, K) CUDA tensor, got "
                         f"{tuple(x.shape)} on {x.device}")
    T, K = x.shape
    N = w_q.shape[-1]
    code = _build.dtype_code(x)
    if not x.is_contiguous():
        raise ValueError(f"{op}: x must be contiguous")
    check_input(op, "w_q", w_q, (K, N), torch.int8, x.device)
    scale = scale.float().contiguous()
    check_input(op, "scale", scale, (N,), torch.float32, x.device)
    out = torch.empty((T, N), dtype=x.dtype, device=x.device)
    if T == 0 or N == 0:
        return out
    err = _build.library().rt_quant_matmul(
        _build.ptr(x), _build.ptr(w_q), _build.ptr(scale), _build.ptr(out),
        T, K, N, code, _build.stream_handle())
    _build.check_launch(err, op)
    quant_matmul.launches += 1
    return out


def quant_decode_attention_plain(q, k_q, v_q, k_scale, v_scale, kv_mask):
    """One-token decode over an int8 contiguous cache (the reference
    ``xla`` implementation). q: (B, Hq, D); k_q/v_q: (B, W, Hkv, D) int8;
    k_scale/v_scale: (B, W, Hkv); kv_mask: (B, W) bool."""
    return decode_attention_plain(q, dequantize_rows(k_q, k_scale),
                                  dequantize_rows(v_q, v_scale), kv_mask)


def quant_paged_decode_attention_plain(q, k_pages, v_pages, k_scales,
                                       v_scales, page_table, kv_mask):
    """One-token decode through an int8 page pool: gather, then
    dequantize only the gathered pages, never the pool. k/v_pages:
    (P, ps, Hkv, D) int8; k/v_scales: (P, ps, Hkv); page_table: (B, NP)
    int32; kv_mask: (B, NP * ps) bool."""
    k = dequantize_rows(gather_pages(k_pages, page_table),
                        gather_pages(k_scales, page_table))
    v = dequantize_rows(gather_pages(v_pages, page_table),
                        gather_pages(v_scales, page_table))
    return decode_attention_plain(q, k, v, kv_mask)


def _check_quant_rows(op, q, k, v, ks, vs, rows_shape):
    """int8 payloads ``rows_shape + (D,)`` and bf16 scales
    ``rows_shape``, on q's device."""
    D = q.shape[2]
    for name, t in (("k", k), ("v", v)):
        check_input(op, name, t, tuple(rows_shape) + (D,), torch.int8,
                    q.device, aligned=True)
    for name, t in (("k_scale", ks), ("v_scale", vs)):
        check_input(op, name, t, rows_shape, torch.bfloat16, q.device)


def quant_decode_attention(q, k_q, v_q, k_scale, v_scale, kv_mask):
    """The kernel for CUDA tensors; the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return quant_decode_attention_plain(q, k_q, v_q, k_scale, v_scale,
                                            kv_mask)
    op = "quant_decode_attention"
    B, Hq, D = q.shape
    W, Hkv = k_q.shape[1], k_q.shape[2]
    code = check_query(op, q, Hkv)
    _check_quant_rows(op, q, k_q, v_q, k_scale, v_scale, (B, W, Hkv))
    check_input(op, "kv_mask", kv_mask, (B, W), torch.bool, q.device)
    o_part, ml, out = splitkv_buffers(q, Hkv, W)
    err = _build.library().rt_quant_decode_attention(
        _build.ptr(q), _build.ptr(k_q), _build.ptr(v_q), _build.ptr(k_scale),
        _build.ptr(v_scale), _build.ptr(kv_mask), _build.ptr(o_part),
        _build.ptr(ml[0]), _build.ptr(ml[1]), _build.ptr(out), B, W, Hkv,
        Hq // Hkv, D, code, _build.stream_handle())
    _build.check_launch(err, op)
    quant_decode_attention.launches += 1
    return out


def quant_paged_decode_attention(q, k_pages, v_pages, k_scales, v_scales,
                                 page_table, kv_mask):
    """The kernel for CUDA tensors; the plain version for CPU tensors.
    Table entries must name pages of the pool."""
    if q.device.type == "cpu":
        return quant_paged_decode_attention_plain(
            q, k_pages, v_pages, k_scales, v_scales, page_table, kv_mask)
    op = "quant_paged_decode_attention"
    B, Hq, D = q.shape
    P, ps, Hkv = k_pages.shape[:3]
    NP = page_table.shape[1]
    code = check_query(op, q, Hkv)
    _check_quant_rows(op, q, k_pages, v_pages, k_scales, v_scales,
                      (P, ps, Hkv))
    check_input(op, "page_table", page_table, (B, NP), torch.int32, q.device)
    check_input(op, "kv_mask", kv_mask, (B, NP * ps), torch.bool, q.device)
    o_part, ml, out = splitkv_buffers(q, Hkv, NP * ps)
    err = _build.library().rt_quant_paged_decode_attention(
        _build.ptr(q), _build.ptr(k_pages), _build.ptr(v_pages),
        _build.ptr(k_scales), _build.ptr(v_scales), _build.ptr(page_table),
        _build.ptr(kv_mask), _build.ptr(o_part), _build.ptr(ml[0]),
        _build.ptr(ml[1]), _build.ptr(out), B, NP, ps, Hkv, Hq // Hkv, D,
        code, _build.stream_handle())
    _build.check_launch(err, op)
    quant_paged_decode_attention.launches += 1
    return out


quant_matmul.launches = 0
quant_decode_attention.launches = 0
quant_paged_decode_attention.launches = 0
