"""Prefill attention: the flash kernel's wrapper and its plain version.

Replaces ``src/repro/kernels/flash_attention.py`` ``flash_attention_fwd``.
The kernel (``csrc/flash_attention.cu``) keeps the reference layouts,
q ``(B, S, Hq, D)`` and k/v ``(B, T, Hkv, D)``, and reads the kv head of
q head ``h`` as ``h // G`` without replicating K/V. At head dim 80 it
runs the plain version's chunked loop op for op (``csrc/
flash_chunked.cuh``), so there it equals :func:`flash_attention_plain`
bit for bit at the same ``chunk``: each score and each P.V output one
fma chain in the plain order, run side by side in register micro-tiles
on the f32 CUDA cores, whose rate bounds it. See the sources for what
bounds the other bodies and their design.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import plan as P
from repro_torch.kernels.dispatch import meta_launch

NEG_INF = -1e30

#: Head dims the kernel is instantiated for (80: zamba2-2.7b and
#: hubert-xlarge; 160: stablelm-12b).
HEAD_DIMS = (16, 32, 64, 80, 128, 160)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: int = 0, chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention over KV chunks in f32, the counterpart of
    the reference ``chunked_attention`` (the ``xla`` implementation).
    q: (B, S, Hq, D); k, v: (B, T, Hkv, D) -> (B, S, Hq, D)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    chunk = min(chunk, T)
    scale = 1.0 / math.sqrt(D)
    qh = q.float().reshape(B, S, Hkv, G, D)
    qpos = torch.arange(S, device=q.device)
    m = torch.full((B, Hkv, G, S), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, S), device=q.device)
    acc = torch.zeros((B, Hkv, G, S, D), device=q.device)
    for start in range(0, T, chunk):
        kb = k[:, start:start + chunk].float()
        vb = v[:, start:start + chunk].float()
        kpos = start + torch.arange(kb.shape[1], device=q.device)
        s = torch.einsum("bshgd,bthd->bhgst", qh, kb) * scale
        mask = torch.ones((S, kb.shape[1]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhgst,bthd->bhgsd",
                                                    p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]      # (B,Hkv,G,S,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    chunk: int = 512) -> torch.Tensor:
    """The kernel for CUDA tensors; the plain version for CPU tensors.
    ``chunk`` is the plain version's loop over keys, which the head-dim-80
    body runs too; the other bodies ignore it. On ``meta`` the checks and
    an empty output."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     chunk=chunk)
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
    if q.device.type not in _build.KERNEL_DEVICES:
        raise ValueError(f"flash_attention: tensors on {q.device}")
    if tuple(k.shape) != (B, T, Hkv, D) or tuple(v.shape) != (B, T, Hkv, D):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} not a multiple of "
                         f"Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    code = _build.dtype_code(q)
    out = torch.empty_like(q)
    if q.device.type == "meta":
        return meta_launch("flash_attention", out)
    lib = _build.library()
    err = lib.rt_flash_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        B, S, T, Hq, Hkv, D, int(bool(causal)), int(window), int(chunk),
        code, _build.stream_handle())
    _build.check_launch(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0

#: Query rows a block of the CUDA-core and tensor-core bodies, and of the
#: D-80 body (csrc/flash_attention.cu BQ / MMA_BQ, csrc/flash_chunked.cuh
#: QR), its key tile and its threads.
BQ, CHUNKED_QR, CHUNKED_KT, CHUNKED_THREADS = 64, 64, 64, 256


def chunked_smem(D: int, chunk: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of the D-80 body at ``chunk`` (already capped
    at T; ``csrc/flash_chunked.cuh`` ``smem_bytes``): the Q rows and two
    K/V tiles in f32 rows of D + 4, a chunk's scores in rows of whole key
    tiles + 16, m, l and alpha, and for bf16 two tiles as they land."""
    pitch = D + 4
    score = P.cdiv(chunk, CHUNKED_KT) * CHUNKED_KT + 16
    raw = 2 * CHUNKED_KT * D * 2 if dtype == torch.bfloat16 else 0
    return 4 * (CHUNKED_QR * pitch + 2 * CHUNKED_KT * pitch
                + CHUNKED_QR * score + 3 * CHUNKED_QR) + raw


def launch_plan(B: int, S: int, T: int, Hq: int, Hkv: int, D: int,
                dtype: torch.dtype, *, chunk: int = 512,
                aligned: bool = True) -> P.KernelPlan:
    """What :func:`flash_attention` launches for q (B, S, Hq, D) and k/v
    (B, T, Hkv, D) of ``dtype`` (``csrc/flash_attention.cu``
    ``dispatch``): at D 80 the plain version's chunked order; else, for
    bf16 whose pointers are 16-byte aligned (``aligned``, as fresh
    allocations are), the tensor-core body; else the CUDA-core body. 64
    query rows a block, in reverse order along S for the first two. One
    block column per (b * Hq + h)."""
    tn = P.type_name(dtype)
    if Hkv <= 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} not a multiple of "
                         f"Hkv={Hkv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    results = (((B, S, Hq, D), dtype),)
    if B <= 0 or S <= 0:
        return P.KernelPlan((), results)
    if D == 80:
        if chunk <= 0:
            raise ValueError(f"flash_attention: chunk {chunk} < 1")
        rows, name, threads, reverse = (CHUNKED_QR,
                                        f"flash_fwd_chunked<{tn},80>",
                                        CHUNKED_THREADS, True)
        smem = chunked_smem(D, min(chunk, T), dtype)
    elif dtype == torch.bfloat16 and aligned:
        rows, name, threads, reverse = BQ, f"flash_fwd_mma<{D}>", 128, True
        smem = 2 * (D + 8) * (BQ + 4 * 64)
    else:
        rows, name, threads, reverse = (BQ, f"flash_fwd_kernel<{tn},{D}>",
                                        256, False)
        smem = 4 * (BQ * D + 32 * (D + 1) + 32 * D + BQ * 33 + 3 * BQ)
    ny = P.cdiv(S, rows)

    def tiles(bx, by, bz):
        q_tile = ny - 1 - by if reverse else by
        return [(bx // Hq, q_tile, bx % Hq, np.zeros_like(bx))]

    out = P.Output("out", (B, S, Hq, D), dtype, (1, rows, 1, D), tiles)
    return P.KernelPlan((P.Launch(name, P.grid3(B * Hq, ny),
                                  P.grid3(threads), 0, smem, (out,)),),
                        results)


def library_plan(B: int, S: int, T: int, Hq: int, Hkv: int, D: int,
                 dtype: torch.dtype, *, chunk: int = 512,
                 aligned: bool = True):
    """The library's plan of the same call (``rt_flash_attention_plan``)."""
    return P.library_plan("rt_flash_attention_plan", B, S, T, Hq, D,
                          int(chunk), P.dtype_code(dtype), int(aligned))
