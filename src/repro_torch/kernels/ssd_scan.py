"""Chunked SSD (Mamba-2) scan: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces ``src/repro/kernels/ssd_scan.py`` ``ssd_scan_pallas``. The
plain version is the reference's ``ssd_chunked`` (the ``xla``
implementation), op for op: intra-chunk decay-masked products, chunk
summaries, and the recurrence over chunks. The kernel runs the chunks in
parallel in three launches (each chunk's state, the pass over chunks,
each chunk's outputs) through an f32 workspace the wrapper allocates;
see ``csrc/ssd_scan.cu`` for what bounds it and its design.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels import plan as P
from repro_torch.kernels.dispatch import meta_launch


def _segsum_decay(a_cs: torch.Tensor) -> torch.Tensor:
    """exp(a_cs[t] - a_cs[s]) on the lower triangle (inclusive), else 0.
    a_cs: (..., L, H) -> (..., H, L, L).

    The upper triangle is masked to -inf before the exp, where the
    reference (``repro.models.ssm._segsum_decay``) takes the exp first
    and masks after: the values are the same (exp(-inf) is 0), but past
    ~88 of decay within a chunk (mamba2's chunk of 256 at dt ~ 0.7) the
    reference's masked exp overflows to inf and its gradient is 0 * inf,
    NaN, for dt and A."""
    L = a_cs.shape[-2]
    diff = a_cs[..., :, None, :] - a_cs[..., None, :, :]   # (..., L, L, H)
    diff = torch.movedim(diff, -1, -3)                     # (..., H, L, L)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                device=a_cs.device))
    return torch.exp(torch.where(tri, diff, float("-inf")))


def ssd_chunked(x, dt, A, B, C, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. x (b, S, nh, hp); dt (b, S, nh); A (nh,)
    negative; B, C (b, S, nh, N) (already expanded from groups to
    heads). Returns y (b, S, nh, hp) in x's dtype and the final state
    (b, nh, hp, N) in float32."""
    b, S, nh, hp = x.shape
    N = B.shape[-1]
    L = min(chunk, S)
    nc = -(-S // L)
    pad = nc * L - S
    if pad:
        def zf(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        x, dt, B, C = zf(x), zf(dt), zf(B), zf(C)

    xc = x.reshape(b, nc, L, nh, hp).float()
    dtc = dt.reshape(b, nc, L, nh).float()
    Bc = B.reshape(b, nc, L, nh, N).float()
    Cc = C.reshape(b, nc, L, nh, N).float()

    dA = dtc * A.float()                                   # (b,nc,L,nh)
    a_cs = torch.cumsum(dA, dim=2)                         # (b,nc,L,nh)

    # intra-chunk: the attention-like decay-masked product
    decay = _segsum_decay(a_cs)                            # (b,nc,nh,L,L)
    scores = torch.einsum("bclhn,bcshn->bchls", Cc, Bc)    # (b,nc,nh,L,L)
    M = scores * decay * torch.movedim(dtc, -1, -2)[..., None, :]
    y_diag = torch.einsum("bchls,bcshp->bclhp", M, xc)

    # chunk summaries -> inter-chunk recurrence
    decay_to_end = torch.exp(a_cs[:, :, -1:, :] - a_cs)    # (b,nc,L,nh)
    states = torch.einsum("bcshn,bcshp,bcsh->bchpn",
                          Bc, xc, dtc * decay_to_end)      # (b,nc,nh,hp,N)
    chunk_decay = torch.exp(a_cs[:, :, -1, :])             # (b,nc,nh)

    h = (torch.zeros((b, nh, hp, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    h_prevs = []
    for c in range(nc):                                    # emit PREVIOUS h
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                  # (b,nc,nh,hp,N)

    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp",
                         Cc, h_prevs, torch.exp(a_cs))
    y = (y_diag + y_off).reshape(b, nc * L, nh, hp)[:, :S]
    return y.to(x.dtype), h


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel for CUDA tensors; the plain version for CPU tensors.
    dt and A are float32; x, B and C share a dtype; ``hp`` must be a
    multiple of 16. On ``meta`` the checks, the workspace and empty
    outputs."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B, C, chunk)
    b, S, nh, hp = x.shape
    N = B.shape[-1]
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} on {t.device}, x on "
                             f"{x.device}")
    if x.device.type not in _build.KERNEL_DEVICES:
        raise ValueError(f"ssd_scan: tensors on {x.device}")
    if tuple(dt.shape) != (b, S, nh) or tuple(A.shape) != (nh,) \
            or tuple(B.shape) != (b, S, nh, N) or C.shape != B.shape:
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)} disagree")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError("ssd_scan: dt and A must be float32")
    if B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"ssd_scan: B/C are {B.dtype}/{C.dtype}, x is "
                         f"{x.dtype}")
    if hp % 16 or chunk < 1:
        raise ValueError(f"ssd_scan: head dim {hp} is not a multiple of "
                         f"16, or chunk {chunk} < 1")
    if not all(t.is_contiguous() for t in (x, dt, A, B, C)):
        raise ValueError("ssd_scan: inputs must be contiguous")
    code = _build.dtype_code(x)
    L = min(chunk, S)
    nc = -(-S // L)
    y = torch.empty_like(x)
    h = torch.empty((b, nh, hp, N), dtype=torch.float32, device=x.device)
    # each chunk's state, then each chunk's cumulative sum
    ws = torch.empty(b * nh * nc * (hp * N + L), dtype=torch.float32,
                     device=x.device)
    if x.device.type == "meta":
        return meta_launch("ssd_scan", (y, h))
    err = _build.library().rt_ssd_scan(
        _build.ptr(x), _build.ptr(dt), _build.ptr(A), _build.ptr(B),
        _build.ptr(C), _build.ptr(y), _build.ptr(h), _build.ptr(ws), b, S,
        nh, hp, N, L, code, _build.stream_handle())
    _build.check_launch(err, "ssd_scan")
    ssd_scan.launches += 1
    return y, h


ssd_scan.launches = 0


#: Threads of steps 1 and 3 and of the pass; state elements a pass thread
#: owns; rows of a sub-tile and its padded row (``csrc/ssd_scan.cu``).
SSD_THREADS, PASS_THREADS, PASS_ELEMS, SSD_TS, SSD_LS = 256, 64, 8, 64, 68


def launch_plan(b: int, S: int, nh: int, hp: int, N: int,
                dtype: torch.dtype, *, chunk: int = 128) -> P.KernelPlan:
    """What :func:`ssd_scan` launches for x (b, S, nh, hp) of ``dtype``
    and B/C of state N (``csrc/ssd_scan.cu`` ``dispatch``): step 1 one
    block per (b * nh, chunk, slice of PT = 64, 32 or 16 columns of hp),
    writing the chunk's state and (slice 0) its cumulative sum into the
    workspace; step 2 one thread per 8 state elements of a (b * nh),
    rewriting each chunk's state in place to the state it starts from and
    writing the final state; step 3 as step 1, writing y."""
    tn = P.type_name(dtype)
    if hp % 16 or chunk < 1 or hp <= 0 or N <= 0:
        raise ValueError(f"ssd_scan: head dim {hp} is not a multiple of "
                         f"16, or chunk {chunk} < 1")
    results = (((b, S, nh, hp), dtype), ((b, nh, hp, N), torch.float32))
    if b <= 0 or S <= 0 or nh <= 0:
        return P.KernelPlan((), results)
    L = min(chunk, S)
    nc = P.cdiv(S, L)
    ppt = 4 if hp % 64 == 0 else 2 if hp % 32 == 0 else 1
    PT = 16 * ppt
    n4 = P.cdiv(N, 4) * 4
    smem_state = 4 * (2 * L + SSD_TS * (n4 + 4) + SSD_TS * PT + 4)
    smem_out = 4 * (2 * L + 2 * N * SSD_LS + SSD_TS * PT + SSD_TS * SSD_LS
                    + 4)
    if max(smem_state, smem_out) > P.SMEM_OPTIN_BYTES:
        raise ValueError(f"ssd_scan: chunk {L} at state {N} needs "
                         f"{max(smem_state, smem_out)} B of shared memory a "
                         f"block, past {P.SMEM_OPTIN_BYTES}")
    BH, hpN = b * nh, hp * N
    grid = P.grid3(BH, nc, hp // PT)
    npass = P.cdiv(hpN // PASS_ELEMS, PASS_THREADS)
    pass_cols = PASS_THREADS * PASS_ELEMS

    def zero(a):
        return np.zeros_like(a)

    states = P.Output("states", (BH, nc, hp, N), torch.float32,
                      (1, 1, PT, N),
                      lambda bx, by, bz: [(bx, by, bz, zero(bx))])
    acs = P.Output("acs", (BH, nc, L), torch.float32, (1, 1, L),
                   lambda bx, by, bz: [(np.where(bz == 0, bx, -1), by,
                                        zero(bx))])
    step1 = P.Launch(f"ssd_chunk_state<{tn},{ppt}>", grid,
                     P.grid3(SSD_THREADS), 0, smem_state, (states, acs))
    step2 = P.Launch(
        "ssd_state_pass", P.grid3(BH, npass), P.grid3(PASS_THREADS), 0, 0,
        (P.Output("states", (BH, nc, hp, N), torch.float32,
                  (1, nc, pass_cols),
                  lambda bx, by, bz: [(bx, zero(bx), by)],
                  view=(BH, nc, hpN)),
         P.Output("h", (b, nh, hp, N), torch.float32, (1, pass_cols),
                  lambda bx, by, bz: [(bx, by)], view=(BH, hpN))))
    step3 = P.Launch(
        f"ssd_chunk_out<{tn},{ppt}>", grid, P.grid3(SSD_THREADS), 0,
        smem_out,
        (P.Output("y", (b, S, nh, hp), dtype, (1, L, 1, PT),
                  lambda bx, by, bz: [(bx // nh, by, bx % nh, bz)]),))
    return P.KernelPlan((step1, step2, step3), results)


def library_plan(b: int, S: int, nh: int, hp: int, N: int,
                 dtype: torch.dtype, *, chunk: int = 128):
    """The library's plan of the same call (``rt_ssd_scan_plan``)."""
    return P.library_plan("rt_ssd_scan_plan", b, S, nh, hp, N,
                          min(chunk, S), P.dtype_code(dtype))
