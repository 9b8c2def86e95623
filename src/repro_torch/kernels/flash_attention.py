"""Prefill attention: the flash kernel's wrapper and its plain version.

Replaces ``src/repro/kernels/flash_attention.py`` ``flash_attention_fwd``.
The kernel (``csrc/flash_attention.cu``) keeps the reference layouts,
q ``(B, S, Hq, D)`` and k/v ``(B, T, Hkv, D)``, and reads the kv head of
q head ``h`` as ``h // G`` without replicating K/V. At head dim 80 it
runs the plain version's chunked loop op for op (``csrc/
flash_chunked.cuh``), so there it equals :func:`flash_attention_plain`
bit for bit at the same ``chunk``. See the sources for what bounds it
and the design.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

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
    body runs too; the other bodies ignore it."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     chunk=chunk)
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
    if q.device.type != "cuda":
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
    lib = _build.library()
    err = lib.rt_flash_attention(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        B, S, T, Hq, Hkv, D, int(bool(causal)), int(window), int(chunk),
        code, _build.stream_handle())
    _build.check_launch(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
