#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results on lines of its own; any failure
raises and exits non-zero (there is no CPU or plain-version fallback):

1. device and build: the card, its power limit, the ``nvcc`` build of
   every kernel source (with ptxas' register counts, named for the G-1
   instantiations of both split-KV kernels, bf16 and int8 KV, for the SSD
   scan's bf16 kernels at mamba2-1.3b's widths and for RMSNorm's at the
   served widths and row counts, and its spills);
2. every kernel of the main paths against its plain PyTorch version at
   the full-width shapes, in bf16 and f32: the attention kernels at
   minicpm-2b's (D 64; the int8 KV kernels on int8 payloads with bf16
   scales) and again at qwen2-moe's (D 128), the grouped expert GEMM at
   qwen2-moe's decode and prefill rows (f 1408 and 2048, empty experts,
   trailing blocks), the SSD scan at mamba2-1.3b's (S 1024, a ragged
   700, and 16 < chunk), the int8-weight matmul at minicpm-2b's decode
   and prefill rows (and a ragged T 37, K 2300, N 1000, a zero-scale
   column); then each is timed with CUDA events (kernel, plain version,
   one PyTorch library call as a yardstick where one exists) beside the
   least time the card could take, the attention kernels at both head
   dims and the grouped GEMM and the int8 matmul at both row counts;
   the timings of flash (bf16), of the grouped GEMM (bf16) and of the
   int8 matmul at T > 16 name the tensor-core body they ran
   (``mma.sync``), the four split-KV kernels', RMSNorm's and the SSD
   scan's name their body, and the grouped GEMM's checks name the body
   of each dtype (f32: the CUDA cores); the SSD scan's bound is taken at
   the bf16 tensor-core rate (the least time the card could take), with
   the f32 CUDA-core figure, its body's own unit, beside it;

   then the tuning path: ``run_tuning`` of the ``h100`` preset (reps 3,
   written to ``chiprun_out/calibration_h100.json``) with every launch
   count set to 0 before it: every op timed under ``torch`` and
   ``cuda``, every kernel launched, the cuda output equal to the torch
   output on every case (checked once, after the timing),
   ``KernelPolicy.from_calibration`` equal to the payload's policy, the
   ``MeasuredModel`` of every cell feasible against the H100 spec, and
   the roofline-vs-measured rows of ``kernel_model_error``;
3. serving: full minicpm-2b (40 layers, bf16, seeded random weights)
   with the default ``cuda`` kernel policy, 4 slots, max_len 1024:
   ``ServeEngine`` at admit widths 1 and 2, ``PagedServeEngine`` (page
   size 16, the equal-HBM page budget) with bf16 and int8 KV, the
   contiguous engine with int8 KV, and a shared-system-prompt trace
   with the prefix cache off and on. Before each run every kernel's
   launch count is set to 0; after it the run's kernels must have
   risen and the other paths' kernels (the int8-weight matmul among
   them, which no serving path runs) stayed at 0. Paged streams must
   equal the contiguous ones (bf16 and int8), and the warm prefix run
   must hit and prefill fewer tokens. Then a profile of full-width
   decode steps and of one 1024-token prefill (wall time against the
   device time of their kernels, kernels per step, and the shares of
   the split-KV kernel of the step's cache (bf16 contiguous, int8 paged)
   and of the MoE model's grouped GEMM);
4. logit parity at full width: teacher-forced prefill + decode steps
   under the ``cuda`` and ``torch`` policies on the same weights, and
   ``logit_parity`` for bf16 vs int8 KV and for int8 KV under both
   policies;

   then phases 3 and 4 again for full-width qwen2-moe-a2.7b (24 layers,
   60 experts top-4, dropless as served) and mamba2-1.3b (48 layers,
   chunk-mode admission): each model through ``ServeEngine`` and
   ``PagedServeEngine`` with equal streams, ``moe_gemm`` launched only
   in the MoE runs, ``ssd_scan`` only in the SSM runs and no attention
   kernel in the SSM runs; a prefill and a decode-step profile; and
   cuda-vs-torch parity: mamba2 in bf16 under the same tolerance,
   qwen2-moe asserted in f32 at 4 layers and reported in bf16 at full
   depth (logits, argmax and routing agreement); mamba2's prefill profile
   shows each of the SSD scan's three kernels and their share;
5. one JSON line describing the kernels, the card's name and power
   limit, and last the JSON result line.

It exits non-zero without printing a result when no CUDA device is
available or the repository's ``src/`` is missing.
"""
from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.hardware import H100_SXM  # noqa: E402  (pure data)

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit), from
#: the port's one record of them.
HBM_BYTES_PER_S = H100_SXM.hbm_bw
PEAK_OPS = {"bf16_tensor": H100_SXM.peak_flops("bfloat16"),
            "int8_tensor": H100_SXM.peak_flops("int8"),
            "f32_cuda_core": H100_SXM.peak_flops("float32")}

#: f32 kernel vs plain: only the summation order differs (TF32 is off).
F32_TOL = dict(atol=5e-5, rtol=1e-5)
#: bf16: both sides compute in f32 and round once; neighbouring bf16
#: values differ by at most 2^-7 of the value.
BF16_TOL = dict(atol=1e-5, rtol=2 ** -7)
#: The tuner's cases, cuda vs torch, all f32 on the unscaled N(0, 1)
#: inputs the reference's tuner draws: outputs reach tens in RMS (a
#: K-2304 product of unit normals), so the f32 bar's atol is taken
#: relative to the output's RMS. The SSD scan takes exp() of cumulative
#: sums of up to 256 steps of dt * A (about -200 at the chunk's end), so
#: an f32 rounding of the sum moves a decay factor by ~1e-5 of itself.
TUNE_TOL = {"ssd_scan": dict(atol=1e-4, rtol=1e-4)}
#: Teacher-forced logits, cuda vs torch policy, full width in bf16. The
#: two paths round every norm and attention output to bf16 at the same
#: places but may land one ulp apart; 40 layers carry such differences
#: to the logits. 0.25 is the repo's bound for a lossy change of
#: precision (int8 KV, max_logit_dev <= 0.25) — a kernel must not do
#: worse than a deliberate loss of precision.
LOGIT_TOL = 0.25

#: Split-KV decode shapes (B 4, positions 1023/700/300/12 of a 1024-row
#: window) and the paged layout: page size 16, 64 pages per sequence.
DECODE_POS = (1023, 700, 300, 12)

#: MoE parity in f32 (cuda vs torch policy) at full width and this
#: depth, held to the relative bar the reference holds its kernel policy
#: to (tests/test_kernel_dispatch.py): f32 routing does not flip.
MOE_PARITY_LAYERS = 4
MOE_F32_RTOL = 1e-3
PAGE_SIZE, PAGES_PER_SEQ = 16, 64
#: Keys of a kernel's check and timing at a second shape: the ``d128``
#: entry of the attention kernels (qwen2-moe's heads), the ``prefill``
#: entry of ``moe_gemm``.
SUB_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "body")
#: The instruction of the tensor-core bodies (bf16 flash prefill, the
#: bf16 grouped GEMM, the int8-weight matmul at T > 16); a timing's
#: "body" names the body it ran.
MMA = "mma.sync"
CUDA_CORE = "f32 CUDA cores"
#: The split-KV body of all four decode kernels (csrc/splitkv.cuh) at
#: G 1: D / C lanes a cache row, one 16-byte load each of K and V (C = 8
#: bf16, 16 int8 values).
ROW_BODY = "row-parallel, 16-byte lanes"
#: The split kernels' names, as the profiler and ptxas list them: the
#: bf16/f32 pair's and the int8 pair's.
BF16_KERNEL, INT8_KERNEL = "split_rows_kernel", "quant_split_kernel"
#: The SSD scan's body (csrc/ssd_scan.cu): chunks in parallel, three
#: launches (chunk states, the pass over chunks, chunk outputs), each dot
#: product one fma chain in the plain version's order.
SSD_BODY = "chunk-parallel, 3 launches, f32 CUDA cores in the plain order"
#: The SSD scan's kernels, as the profiler and ptxas name them.
SSD_KERNELS = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")
#: The RMSNorm body of every served row (csrc/rmsnorm.cu rmsnorm_vec).
NORM_BODY = "a row in registers, PyTorch's reduction order"
def split_build_lines(entries, kernel: str) -> None:
    """ptxas' registers and spills of a split kernel: one line per G-1
    instantiation (the ones serving runs), then the most any other
    spills. ``entries``: ``_build.ptxas_entries`` of the build log."""
    worst = 0
    for name, regs, spill in entries:
        m = re.search(kernel + r"I(f|13__nv_bfloat16)Li(\d+)ELi(\d+)"
                      r"ELb([01])E", name)
        if not m:
            continue
        if m.group(3) != "1":
            worst = max(worst, spill)
            continue
        print(f"[build] {kernel}<{'f32' if m.group(1) == 'f' else 'bf16'}"
              f", D {m.group(2)}, G 1, "
              f"{'paged' if m.group(4) == '1' else 'contiguous'}>: "
              f"{regs} registers, {spill} bytes spill stores")
    print(f"[build] {kernel} at G 2-8: at most {worst} bytes spill "
          f"stores")


def served_build_lines(entries, served) -> None:
    """ptxas' registers and spills of each (label, name pattern) in
    ``served`` (``_build.SERVED_BUILDS``); fails if one is not in the
    build."""
    for label, pattern in served:
        found = [(regs, spill) for name, regs, spill in entries
                 if re.search(pattern, name)]
        check(len(found) == 1, f"{len(found)} builds of {label} "
              f"({pattern}) in the build log")
        print(f"[build] {label}: {found[0][0]} registers, {found[0][1]} "
              f"bytes spill stores")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


#: GPU cycles (~0.5 ms) of a spin queued before each timed call: the host
#: then enqueues the call and its end event before the card reaches the
#: start event, so a call of a few microseconds is timed on the card alone.
SPIN_CYCLES = 1_000_000


def time_ms(fn, iters: int = 30, warm: int = 3, flush=None) -> float:
    """Median CUDA-event time of one call; ``flush`` (untimed) runs
    before each call so inputs come from device memory, not L2."""
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(nbytes: float, ops: float, peak: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ===========================================================================
# Phase 2: kernels against their plain versions
# ===========================================================================
def kernel_phase(cfg, moe_cfg, ssm_cfg):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    d = cfg.d_model
    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_                      # 256 MB > the 50 MB L2

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    entries = {}

    def compare(name, got, want, dtype, what):
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()), f"{name} {what}: "
              f"non-finite output")
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), **tol,
                                   msg=lambda m: f"{name} {what}: {m}")
        print(f"[kernels] {name:<16} {what:<40} max|err| {err:.3e} "
              f"(tol atol {tol['atol']:g} rtol {tol['rtol']:g}) ok")
        return err

    # --- rmsnorm: prefill rows (2 x 1024) and decode rows (4) ------------
    s = torch.randn(d, generator=gen, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        for rows in (4, 2048):
            x = rnd(rows, d, dtype=dtype)
            err = compare("rmsnorm", rmsnorm(x, s, eps=1e-6),
                          rmsnorm_plain(x, s, eps=1e-6), dtype,
                          f"({rows}, {d}) {str(dtype)[6:]}")
    x = rnd(2048, d, dtype=torch.bfloat16)
    sb = s.to(torch.bfloat16)
    nbytes = 2 * x.numel() * 2 + s.numel() * 4
    b_ms, b_by = bound(nbytes, 4 * x.numel(), "f32_cuda_core")
    entries["rmsnorm"] = dict(
        name="rmsnorm", route="cuda",
        source="src/repro_torch/kernels/csrc/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm.py:25", max_abs_err=err,
        ms=time_ms(lambda: rmsnorm(x, s, eps=1e-6), flush=flush),
        plain_ms=time_ms(lambda: rmsnorm_plain(x, s, eps=1e-6), flush=flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.rms_norm(x, (d,), sb, 1e-6),
                           flush=flush),
        library_call="F.rms_norm, bf16 weight", body=NORM_BODY,
        shape=f"x (2048, {d}) bf16")

    # --- attention at D 64 (minicpm-2b), then D 128 (qwen2-moe) ----------
    B, W = 4, 1024
    mask = (torch.arange(W, device=dev)[None, :]
            <= torch.tensor(DECODE_POS, device=dev)[:, None])
    entries["flash_attention"] = flash_entry(cfg, rnd, compare, flush,
                                             ((2, 1024), (1, 700)))
    entries["decode_attention"] = decode_entry(cfg, rnd, compare, flush, mask)
    entries.update(decode_variants(cfg, gen, rnd, compare, flush, mask))
    d128 = {"flash_attention": flash_entry(moe_cfg, rnd, compare, flush,
                                           ((1, 1024),)),
            "decode_attention": decode_entry(moe_cfg, rnd, compare, flush,
                                             mask),
            **decode_variants(moe_cfg, gen, rnd, compare, flush, mask)}
    for name, e in d128.items():
        entries[name]["d128"] = {k: e[k] for k in SUB_KEYS if k in e}
    entries["moe_gemm"] = moe_gemm_kernel(moe_cfg, gen, rnd, compare, flush)
    entries["ssd_scan"] = ssd_scan_kernel(ssm_cfg, gen, rnd, compare, flush)
    entries["quant_matmul"] = quant_matmul_kernel(cfg, gen, rnd, compare,
                                                  flush)
    for e in entries.values():
        for label, t in (("", e), *((f"{k} ", e[k]) for k in ("d128",
                                                              "prefill")
                                    if k in e)):
            lib = ("none" if t["library_ms"] is None
                   else f"{t['library_ms']:.4f} ms")
            body = f" [{t['body']}]" if "body" in t else ""
            print(f"[time] {e['name']:<16} {label}{t['shape']}{body}: "
                  f"kernel "
                  f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
                  f"{lib} ({e['library_call']}), bound {t['bound_ms']:.4f} "
                  f"ms ({t['bound_by']})")
    del scratch
    return entries


def flash_entry(cfg, rnd, compare, flush, shapes):
    """Flash prefill at ``cfg``'s heads against its plain version at each
    causal (B, S) of ``shapes`` in f32 and bf16, then timed in bf16 at
    the first."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)

    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for dtype in (torch.float32, torch.bfloat16):
        for B, S in shapes:
            q = rnd(B, S, H, D, dtype=dtype)
            k = rnd(B, S, Hkv, D, dtype=dtype)
            v = rnd(B, S, Hkv, D, dtype=dtype)
            err = compare("flash_attention", flash_attention(q, k, v),
                          flash_attention_plain(q, k, v), dtype,
                          f"B{B} S{S} H{H} Hkv{Hkv} D{D} causal "
                          f"{str(dtype)[6:]}")
    B, S = shapes[0]
    q, k, v = (rnd(B, S, h, D, dtype=torch.bfloat16) for h in (H, Hkv, Hkv))
    pairs = S * (S + 1) // 2                   # causal (q, k) pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = bound(nbytes, 4 * D * pairs * B * H, "bf16_tensor")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:89", max_abs_err=err,
        ms=time_ms(lambda: flash_attention(q, k, v), flush=flush),
        plain_ms=time_ms(lambda: flash_attention_plain(q, k, v), iters=10,
                         flush=flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush=flush),
        library_call="SDPA, causal", mma=MMA, body=MMA,
        shape=f"B{B} S{S} Hq{H} Hkv{Hkv} D{D} causal bf16")


def decode_entry(cfg, rnd, compare, flush, mask):
    """The contiguous split-KV decode kernel at ``cfg``'s heads (B 4, W
    1024, ragged ``mask``) against its plain version, timed in bf16."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)

    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, W = mask.shape
    for dtype in (torch.float32, torch.bfloat16):
        q = rnd(B, H, D, dtype=dtype)
        kc, vc = rnd(B, W, Hkv, D, dtype=dtype), rnd(B, W, Hkv, D,
                                                     dtype=dtype)
        err = compare("decode_attention", decode_attention(q, kc, vc, mask),
                      decode_attention_plain(q, kc, vc, mask), dtype,
                      f"B{B} W{W} H{H} Hkv{Hkv} D{D} {str(dtype)[6:]}")
    valid = int(mask.sum())
    nbytes = 2 * (2 * q.numel() + 2 * valid * Hkv * D) + mask.numel()
    b_ms, b_by = bound(nbytes, 4 * D * H * valid, "bf16_tensor")
    q4, k4, v4 = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
    m4 = mask[:, None, None, :]
    return dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:44",
        max_abs_err=err,
        ms=time_ms(lambda: decode_attention(q, kc, vc, mask), flush=flush),
        plain_ms=time_ms(lambda: decode_attention_plain(q, kc, vc, mask),
                         flush=flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=m4, enable_gqa=True), flush=flush),
        library_call="SDPA, bool mask", body=ROW_BODY,
        shape=f"B{B} W{W} Hq{H} Hkv{Hkv} D{D} bf16, {valid} valid rows")


def moe_gemm_kernel(cfg, gen, rnd, compare, flush):
    """The grouped expert GEMM at qwen2-moe's widths: decode (4 slots x
    top-4 = 16 rows) and a 1024-token prefill (4096 rows), the gate/up
    shape (d 2048 -> f 1408) and the down shape (1408 -> 2048), with
    empty experts and the trailing blocks the sort's static bound
    leaves. bf16 runs the tensor-core body, f32 the CUDA-core one.
    Timed at the decode gate/up shape (and the prefill one)."""
    import torch
    from repro_torch.kernels.moe_gemm import (
        BLOCK_M, block_rows, grouped_gemm_padded, grouped_gemm_padded_plain,
        sort_by_expert)

    dev = torch.device("cuda")
    m = cfg.moe
    E, K, d, f = m.n_experts, m.experts_per_token, cfg.d_model, m.d_expert

    def case(T, d_in, f_out, dtype, empty):
        """Rows routed uniformly, experts 0..empty-1 left without a row."""
        x = rnd(T, d_in, dtype=dtype)
        w = (torch.randn(E, d_in, f_out, generator=gen, device=dev)
             / math.sqrt(d_in)).to(dtype)
        eor = torch.randint(0, E, (T,), generator=gen, device=dev)
        eor = torch.where(eor < empty, eor + empty, eor)
        xp, be, inv, Tp = sort_by_expert(x, eor, E, BLOCK_M)
        rows = block_rows(inv, Tp // BLOCK_M, BLOCK_M)
        trailing = be == E
        check(bool(trailing.any()) and not bool(rows[trailing].any()),
              f"moe_gemm T{T}: no trailing block, or one holding rows")
        return x, w, eor, (xp, w, be, rows), inv, int(torch.unique(
            eor).numel())

    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for T, label in ((4 * K, "decode"), (1024 * K, "prefill")):
            for d_in, f_out in ((d, f), (f, d)):
                _, _, eor, args, inv, used = case(T, d_in, f_out, dtype, 4)
                body = CUDA_CORE if dtype == torch.float32 else MMA
                err = max(err, compare(
                    "moe_gemm", grouped_gemm_padded(*args)[inv],
                    grouped_gemm_padded_plain(*args)[inv], dtype,
                    f"{label} T{T} {d_in}->{f_out} {used}/{E} "
                    f"{str(dtype)[6:]} {body}"))

    def timed(T):
        x, w, eor, args, inv, used = case(T, d, f, torch.bfloat16, 0)
        present = torch.unique(eor)
        counts = (eor[:, None] == present[None, :]).sum(0)
        xe = x.new_zeros(len(present), int(counts.max()), d)
        for j, e in enumerate(present.tolist()):
            rows = x[eor == e]
            xe[j, :len(rows)] = rows
        ws = w[present].contiguous()
        nbytes = 2 * (T * d + used * d * f + T * f) + 8 * len(args[2])
        b_ms, b_by = bound(nbytes, 2 * T * d * f, "bf16_tensor")
        return dict(max_abs_err=err,
                    ms=time_ms(lambda: grouped_gemm_padded(*args),
                               flush=flush),
                    plain_ms=time_ms(lambda: grouped_gemm_padded_plain(*args),
                                     iters=10, flush=flush),
                    bound_ms=b_ms, bound_by=b_by,
                    library_ms=time_ms(lambda: torch.bmm(xe, ws), flush=flush),
                    body=MMA,
                    shape=f"T{T} rows d{d} f{f} bf16, {used}/{E} experts, "
                          f"block {args[0].shape[0] // len(args[2])}")

    dec, pre = timed(4 * K), timed(1024 * K)
    return dict(name="moe_gemm", route="cuda",
                source="src/repro_torch/kernels/csrc/moe_gemm.cu",
                replaces="src/repro/kernels/moe_gemm.py:32",
                library_call="torch.bmm over the present experts' padded "
                             "rows, layout not timed", mma=MMA,
                prefill={k: pre[k] for k in SUB_KEYS if k in pre}, **dec)


def ssd_scan_kernel(cfg, gen, rnd, compare, flush):
    """The chunked SSD scan at mamba2-1.3b's widths (64 heads of 64, state
    128, chunk 256): a 1024-token prefill, a ragged 700 (two sequences)
    and a 16-token chunk-mode floor (S < chunk). Timed at B1 S1024."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
    from repro_torch.models.ssm import ssm_dims

    dev = torch.device("cuda")
    dims = ssm_dims(cfg)
    nh, hp, N, L = dims["nh"], dims["hp"], dims["N"], cfg.ssm.chunk_size

    def inputs(b, S, dtype):
        x = rnd(b, S, nh, hp, dtype=dtype)
        dt = F.softplus(torch.randn(b, S, nh, generator=gen, device=dev)
                        - 2.0)
        A = -torch.exp(torch.randn(nh, generator=gen, device=dev) * 0.5)
        B, C = ((torch.randn(b, S, nh, N, generator=gen, device=dev)
                 / N ** 0.25).to(dtype) for _ in range(2))
        return x, dt, A, B, C

    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for b, S in ((1, 1024), (2, 700), (1, 16)):
            args = inputs(b, S, dtype)
            (y, h), (yw, hw) = ssd_scan(*args, chunk=L), ssd_chunked(*args, L)
            what = f"b{b} S{S} nh{nh} hp{hp} N{N} L{L} {str(dtype)[6:]}"
            err = max(err, compare("ssd_scan", y, yw, dtype, f"y {what}"))
            compare("ssd_scan", h, hw, torch.float32, f"state {what}")
    b, S = 1, 1024
    args = inputs(b, S, torch.bfloat16)
    # what the chunked algorithm needs per (sequence, head, chunk): the
    # causal C.B scores and their product with x, the carried-state term
    # and the state update, each 2 operations per multiply-add
    nc = -(-S // L)
    pairs = L * (L + 1) // 2
    ops = b * nh * nc * 2 * (pairs * N + pairs * hp + 2 * L * N * hp)
    nbytes = (2 * b * S * nh * (2 * hp + 2 * N) + 4 * b * S * nh + 4 * nh
              + 4 * b * nh * hp * N)
    b_ms, b_by = bound(nbytes, ops, "bf16_tensor")
    return dict(name="ssd_scan", route="cuda",
                source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                replaces="src/repro/kernels/ssd_scan.py:79", max_abs_err=err,
                ms=time_ms(lambda: ssd_scan(*args, chunk=L), flush=flush),
                plain_ms=time_ms(lambda: ssd_chunked(*args, L), iters=10,
                                 flush=flush),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                library_call="none: no single PyTorch call computes a "
                             "chunked SSD scan", body=SSD_BODY,
                bound_ms_f32_cuda_core=bound(nbytes, ops, "f32_cuda_core")[0],
                shape=f"b{b} S{S} nh{nh} hp{hp} N{N} chunk {L} bf16")


def quant_matmul_kernel(cfg, gen, rnd, compare, flush):
    """The int8-weight matmul at minicpm-2b's widths (K 2304, N 17280 =
    3 d_ff, the N the tuner recovers from the int8 FFN bytes), at the
    decode rows (4 slots) and a 1024-token prefill, plus a ragged T 37,
    K 2300, N 1000 (N % 16 != 0: the kernel's scalar weight loads).
    Column 0 of every weight is zero (scale 0). x is scaled by 1/sqrt(K),
    so outputs are of order 1. Timed in bf16 at both row counts."""
    import torch
    from repro_torch.kernels.quant import (quant_matmul, quant_matmul_plain,
                                           quantize_channels)

    dev = torch.device("cuda")
    K, N = cfg.d_model, 3 * cfg.d_ff

    def case(T, K, N, dtype):
        x = (torch.randn(T, K, generator=gen, device=dev) / K ** 0.5) \
            .to(dtype)
        w = torch.randn(K, N, generator=gen, device=dev)
        w[:, 0] = 0.0
        w_q, scale = quantize_channels(w)
        return x, w_q, scale

    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for T, k, n, label in ((4, K, N, "decode"), (1024, K, N, "prefill"),
                               (37, 2300, 1000, "ragged")):
            x, w_q, scale = case(T, k, n, dtype)
            got = quant_matmul(x, w_q, scale)
            check(not bool(got[:, 0].any()), "quant_matmul: zero-scale "
                  "column is not zero")
            err = max(err, compare(
                "quant_matmul", got, quant_matmul_plain(x, w_q, scale),
                dtype, f"{label} T{T} K{k} N{n} {str(dtype)[6:]}"))

    def timed(T):
        x, w_q, scale = case(T, K, N, torch.bfloat16)
        w_deq = w_q.to(torch.bfloat16)          # exact for -127..127
        sc = scale.to(torch.bfloat16)
        nbytes = 2 * T * K + K * N + 4 * N + 2 * T * N
        b_ms, b_by = bound(nbytes, 2 * T * K * N, "bf16_tensor")
        return dict(max_abs_err=err,
                    ms=time_ms(lambda: quant_matmul(x, w_q, scale),
                               flush=flush),
                    plain_ms=time_ms(lambda: quant_matmul_plain(x, w_q, scale),
                                     flush=flush),
                    bound_ms=b_ms, bound_by=b_by,
                    library_ms=time_ms(lambda: torch.matmul(x, w_deq) * sc,
                                       flush=flush),
                    body=MMA if T > 16 else "f32 CUDA cores",
                    shape=f"T{T} K{K} N{N} x bf16, w int8 + f32 scales")

    dec, pre = timed(4), timed(1024)
    return dict(name="quant_matmul", route="cuda",
                source="src/repro_torch/kernels/csrc/quant_matmul.cu",
                replaces="src/repro/kernels/quant.py:132",
                library_call="torch.matmul against the weight dequantized "
                             "to bf16 beforehand (not timed), then the "
                             "scale", mma=MMA,
                prefill={k: pre[k] for k in SUB_KEYS}, **dec)


def decode_variants(cfg, gen, rnd, compare, flush, mask):
    """The paged, int8 and int8-paged split-KV decode kernels at the
    full-width decode shapes: a 257-page pool whose table is a seeded
    permutation of pages 1..256, so the addressing is scattered."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_attention import (
        gather_pages, paged_decode_attention, paged_decode_attention_plain)
    from repro_torch.kernels.quant import (
        dequantize_rows, quant_decode_attention,
        quant_decode_attention_plain, quant_paged_decode_attention,
        quant_paged_decode_attention_plain, quantize_rows)

    dev = mask.device
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, W = mask.shape
    ps, NP = PAGE_SIZE, PAGES_PER_SEQ
    P = B * NP + 1
    pt = (torch.randperm(P - 1, generator=gen, device=dev) + 1) \
        .reshape(B, NP).to(torch.int32)
    ar = torch.arange(NP * ps, device=dev)[None, :]
    pmask = (ar <= torch.tensor(DECODE_POS, device=dev)[:, None]) & (ar < W)
    check(torch.equal(pmask, mask), "paged mask != contiguous mask")

    def int8_rows(*shape):
        return quantize_rows(torch.randn(*shape, generator=gen, device=dev))

    kq, ks = int8_rows(B, W, Hkv, D)
    vq, vs = int8_rows(B, W, Hkv, D)
    kpq, kps = int8_rows(P, ps, Hkv, D)
    vpq, vps = int8_rows(P, ps, Hkv, D)
    for dtype in (torch.float32, torch.bfloat16):
        q = rnd(B, H, D, dtype=dtype)
        kp, vp = rnd(P, ps, Hkv, D, dtype=dtype), rnd(P, ps, Hkv, D,
                                                     dtype=dtype)
        paged, tail = f"B{B} NP{NP} ps{ps} H{H} D{D}", str(dtype)[6:]
        errs = [
            compare("paged_decode", paged_decode_attention(
                q, kp, vp, pt, mask), paged_decode_attention_plain(
                q, kp, vp, pt, mask), dtype, f"{paged} {tail}"),
            compare("quant_decode", quant_decode_attention(
                q, kq, vq, ks, vs, mask), quant_decode_attention_plain(
                q, kq, vq, ks, vs, mask), dtype,
                f"B{B} W{W} H{H} D{D} int8 KV, q {tail}"),
            compare("quant_paged", quant_paged_decode_attention(
                q, kpq, vpq, kps, vps, pt, mask),
                quant_paged_decode_attention_plain(
                q, kpq, vpq, kps, vps, pt, mask), dtype,
                f"{paged} int8 KV, q {tail}")]

    valid = int(mask.sum())
    io = 2 * (2 * q.numel()) + mask.numel()        # q in, out, mask
    ops = 4 * D * H * valid
    by_bf16 = 2 * valid * Hkv * D * 2
    by_int8 = 2 * valid * Hkv * (D + 2)
    m4 = mask[:, None, None, :]

    def sdpa(k, v):
        q4 = q[:, :, None, :]
        k4, v4 = k.transpose(1, 2), v.transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=m4, enable_gqa=True)

    def deq(x, s):
        return dequantize_rows(x, s).to(torch.bfloat16)

    lib_paged = sdpa(gather_pages(kp, pt), gather_pages(vp, pt))
    lib_quant = sdpa(deq(kq, ks), deq(vq, vs))
    lib_qpaged = sdpa(deq(gather_pages(kpq, pt), gather_pages(kps, pt)),
                      deq(gather_pages(vpq, pt), gather_pages(vps, pt)))
    rows = [
        ("paged_decode_attention", "paged_attention.cu",
         "src/repro/kernels/paged_attention.py:66", errs[0],
         lambda: paged_decode_attention(q, kp, vp, pt, mask),
         lambda: paged_decode_attention_plain(q, kp, vp, pt, mask),
         by_bf16 + io + pt.numel() * 4, "bf16_tensor", lib_paged,
         "SDPA over pre-gathered bf16 K/V, gather not timed",
         f"B{B} NP{NP} ps{ps} Hq{H} Hkv{Hkv} D{D} bf16, {P}-page pool, "
         f"{valid} valid rows"),
        ("quant_decode_attention", "quant_attention.cu",
         "src/repro/kernels/quant.py:184", errs[1],
         lambda: quant_decode_attention(q, kq, vq, ks, vs, mask),
         lambda: quant_decode_attention_plain(q, kq, vq, ks, vs, mask),
         by_int8 + io, "int8_tensor", lib_quant,
         "SDPA over pre-dequantized bf16 K/V, dequantize not timed",
         f"B{B} W{W} Hq{H} Hkv{Hkv} D{D} int8 KV + bf16 scales, q bf16, "
         f"{valid} valid rows"),
        ("quant_paged_decode_attention", "quant_attention.cu",
         "src/repro/kernels/quant.py:282", errs[2],
         lambda: quant_paged_decode_attention(q, kpq, vpq, kps, vps, pt,
                                              mask),
         lambda: quant_paged_decode_attention_plain(q, kpq, vpq, kps, vps,
                                                    pt, mask),
         by_int8 + io + pt.numel() * 4, "int8_tensor", lib_qpaged,
         "SDPA over pre-gathered, pre-dequantized bf16 K/V, not timed",
         f"B{B} NP{NP} ps{ps} Hq{H} Hkv{Hkv} D{D} int8 KV + bf16 scales, "
         f"q bf16, {P}-page pool, {valid} valid rows"),
    ]
    entries = {}
    for name, src, replaces, err, fn, plain, nbytes, peak, lib, lib_what, \
            shape in rows:
        b_ms, b_by = bound(nbytes, ops, peak)
        entries[name] = dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}", replaces=replaces,
            max_abs_err=err, ms=time_ms(fn, flush=flush),
            plain_ms=time_ms(plain, flush=flush), bound_ms=b_ms,
            bound_by=b_by, library_ms=time_ms(lib, flush=flush),
            library_call=lib_what, shape=shape, body=ROW_BODY)
    return entries


# ===========================================================================
# Phase 2b: the tuner and the measured model
# ===========================================================================
def tune_close(op, got, want):
    """The tuner's cuda output against its torch output (TUNE_TOL);
    returns max |err| over the output's RMS."""
    import torch
    tol = TUNE_TOL.get(op, F32_TOL)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        g, w = g.float(), w.float()
        check(g.shape == w.shape and bool(torch.isfinite(g).all()),
              f"{op}: shape {tuple(g.shape)} vs {tuple(w.shape)}, or "
              f"non-finite")
        rms = max(1.0, float(w.square().mean().sqrt()))
        torch.testing.assert_close(g, w, atol=tol["atol"] * rms,
                                   rtol=tol["rtol"],
                                   msg=lambda m: f"tuner {op}: {m}")
        worst = max(worst, float((g - w).abs().max()) / rms)
    return worst


def tuner_phase(counters):
    """``run_tuning(h100, reps=3)`` on the card, written under
    chiprun_out/: every op timed under torch and cuda, every kernel
    launched, cuda == torch on every case (checked once, after the
    timing, on the same seeded inputs), the calibrated policy, the
    measured model of every cell and the roofline-vs-measured rows.
    Returns the phase's launch counts."""
    import os
    import torch
    from repro_torch.bench import kernel_model_error
    from repro_torch.core.analytical import DesignPoint, MeasuredModel
    from repro_torch.core.workload import lm_workload
    from repro_torch.kernels import tune
    from repro_torch.kernels.dispatch import (KERNEL_OPS, KernelPolicy,
                                              implementations)

    out_dir = ROOT / "chiprun_out"
    os.environ.setdefault("REPRO_TORCH_ARTIFACT_DIR",
                          str(out_dir / "artifacts"))
    t0 = time.perf_counter()
    preset = tune.H100
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    payload = tune.run_tuning(preset, reps=3, device="cuda")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    t_tune = time.perf_counter() - t0
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[tune] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
          f"{total / 2**30:.1f}")
    path = tune.write_calibration(payload, str(out_dir /
                                               "calibration_h100.json"))
    print(f"[tune] {len(payload['entries'])} entries in {t_tune:.1f} s -> "
          f"{Path(path).relative_to(ROOT)} ({payload['timer']}; "
          f"{payload['device']})")
    print(f"[tune] launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"tuner: kernel {name} was not launched")
    entries = payload["entries"]
    check({e["op"] for e in entries} == set(KERNEL_OPS),
          f"tuner: ops {sorted({e['op'] for e in entries})}")
    for e in entries:
        check(set(e["impls"]) == {"torch", "cuda"},
              f"tuner {e['op']}: impls {sorted(e['impls'])}")
        t, c = e["impls"]["torch"], e["impls"]["cuda"]
        print(f"[tune] {e['arch']}/{e['shape']} {e['op']:<28} torch "
              f"{t['best_s'] * 1e3:10.4f} ms {t['best_params'] or ''} cuda "
              f"{c['best_s'] * 1e3:10.4f} ms {c['best_params'] or ''} -> "
              f"{e['winner']}")

    # cuda == torch on each case, on the inputs the case timed
    for arch, shape in preset.cells:
        for case in tune.cases_for_cell(preset.arch(arch),
                                        preset.shape(shape),
                                        bench_batch=preset.bench_batch,
                                        page_sizes=preset.paged_page_sizes,
                                        device="cuda"):
            args = case.make_args()
            impls = implementations(case.op)
            err = tune_close(case.op, impls["cuda"](*args, **case.kwargs),
                             impls["torch"](*args, **case.kwargs))
            print(f"[tune] check {arch}/{shape} {case.op}: max|cuda - torch| "
                  f"/ max(1, rms) {err:.3e} ok")
            del args
    gc.collect()
    torch.cuda.empty_cache()

    pol = KernelPolicy.from_calibration(payload)
    for op, choice in payload["policy"].items():
        check(pol.impl_for(op) == choice["impl"]
              and pol.params_for(op) == choice["params"],
              f"from_calibration {op}: {pol.impl_for(op)} "
              f"{pol.params_for(op)} vs {choice}")
    print(f"[tune] policy: {pol.describe()}; params {dict(pol.params)}")

    for arch, shape in preset.cells:
        wl = lm_workload(preset.arch(arch), preset.shape(shape))
        r = MeasuredModel(wl, payload, chip=H100_SXM).evaluate(
            DesignPoint.make())
        check(r.feasible and r.latency_s > 0, f"MeasuredModel {wl.name}: "
              f"{r.reason}")
        measured = int(r.resources["measured_ops"])
        interp = int(r.resources["interpolated_ops"])
        # the h100 preset times one sequence per case and the cells run at
        # their global batch, so most ops fall outside the 4x match window
        label = ("interpolated, no forecast" if interp > measured
                 else "forecast")
        print(f"[model] {wl.name} (global batch "
              f"{preset.shape(shape).global_batch}; {label}): "
              f"{r.latency_s * 1e3:.3f} ms, {r.gops:.1f} GOP/s, efficiency "
              f"{r.efficiency:.4f} of {H100_SXM.name} bf16 peak; ops "
              f"measured {measured}, interpolated {interp}")
    err = kernel_model_error.run(payload)
    for r in err["op_rows"]:
        print(f"[model] roofline {r['arch']}/{r['shape']} {r['op']:<28} "
              f"measured {r['measured_ms']:.4f} ms ({r['winner']}), "
              f"roofline {r['roofline_ms']:.4f} ms, error {r['err_pct']:.1f} %")
    check(err["pass"], "kernel_model_error did not pass")
    print(f"[model] roofline-vs-measured error median "
          f"{err['median_err_pct']:.2f} % / mean {err['mean_err_pct']:.2f} % "
          f"over {err['ops']} entries")
    print(f"[tune] phase wall time {time.perf_counter() - t0:.1f} s")
    return launches


# ===========================================================================
# Phase 3: serving at full width
# ===========================================================================
PROMPT_LENS = (12, 700, 37, 300, 150, 64, 511, 90)
NEW_TOKENS = 32
#: Shared-system-prompt trace: one 512-token prompt + tails of 8-40.
SYSTEM_LEN, N_SYSTEM_REQS = 512, 8


def drive(label, eng, requests, counters, expect):
    """Serve ``requests`` through ``eng``, every launch count set to 0
    just before and read just after: the kernels in ``expect`` must have
    run, the other paths' kernels must not. Returns the run's record."""
    import numpy as np
    import torch
    from repro_torch.serve import Request

    for fn in counters.values():
        fn.launches = 0
    for i, prompt in enumerate(requests):
        eng.submit(Request(rid=i, prompt=prompt, max_new_tokens=NEW_TOKENS))
    steps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.queue or any(s is not None for s in eng.slots):
        t1 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t1)
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    for name, n in launches.items():
        if name in expect:
            check(n > 0, f"{label}: kernel {name} was not launched")
        else:
            check(n == 0, f"{label}: kernel {name} of another path ran "
                          f"{n} times")
    st = eng.stats
    vocab = eng.cfg.vocab_size
    check(len(eng.finished) == len(requests) and not eng.rejected,
          f"{label}: served {len(eng.finished)}/{len(requests)}, rejected "
          f"{len(eng.rejected)}")
    check(all(len(r.out_tokens) == NEW_TOKENS
              and all(0 <= t < vocab for t in r.out_tokens)
              for r in eng.finished), f"{label}: bad token streams")
    bound_c = eng.scheduler.max_prefill_compiles()
    check(st.prefill_compiles <= bound_c,
          f"{label}: prefill shapes {st.prefill_compiles} > bound {bound_c}")
    toks = sum(len(r.out_tokens) for r in eng.finished)
    p50, p99 = np.percentile(np.array(steps) * 1e3, (50, 99))
    pages = ""
    if hasattr(eng, "pages"):
        pages = (f"; pages {eng.n_pages} ({eng.pages.live_pages} live, "
                 f"{eng.pages.free_pages} free), prefix hits "
                 f"{st.prefix_hits} ({st.prefix_hit_tokens} tokens)")
    print(f"[serve] {label}: {len(eng.finished)}/{len(requests)} requests, "
          f"{toks} tokens in {dt:.3f} s ({toks / dt:.1f} tok/s); step p50 "
          f"{p50:.2f} ms p99 {p99:.2f} ms over {len(steps)} steps; max "
          f"active {st.max_active}; prefill calls {st.prefills}, "
          f"{st.prefill_tokens} tokens, shapes {st.prefill_compiles} (bound "
          f"{bound_c}); kv cache {eng.kv_cache_bytes() / 2**30:.4f} GiB"
          f"{pages}")
    print(f"[serve] {label}: launches {launches}")
    return dict(streams={r.rid: r.out_tokens for r in eng.finished},
                launches=launches, stats=st, tok_s=toks / dt, p50_ms=p50,
                p99_ms=p99, kv_bytes=eng.kv_cache_bytes())


def serve_phase(cfg, params, counters, rt):
    """Full-width serving through both engines, bf16 and int8 KV, and the
    prefix cache; ``rt`` is the bf16 ``cuda``-policy runtime."""
    import dataclasses
    import numpy as np
    from repro_torch.serve import PagedServeEngine, Scheduler, ServeEngine

    rt8 = dataclasses.replace(rt, kv_dtype="int8")
    base = {"rmsnorm", "flash_attention"}

    def engine(paged, run_rt, width=1, prefix=False):
        kw = dict(n_slots=4, max_len=1024, scheduler=Scheduler(
            cfg=cfg, max_len=1024, admit_width=width))
        if paged:
            return PagedServeEngine(params, cfg, run_rt, page_size=PAGE_SIZE,
                                    prefix_cache=prefix, **kw)
        return ServeEngine(params, cfg, run_rt, **kw)

    def prompts(seed):
        rng = np.random.default_rng(seed)
        return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                for n in PROMPT_LENS]

    runs = {}
    for width in (1, 2):
        runs[f"contiguous bf16 w{width}"] = drive(
            f"contiguous bf16, admit_width={width}",
            engine(False, rt, width), prompts(width), counters,
            base | {"decode_attention"})
    reqs = prompts(1)
    for label, paged, run_rt, kernel in (
            ("paged bf16", True, rt, "paged_decode_attention"),
            ("contiguous int8", False, rt8, "quant_decode_attention"),
            ("paged int8", True, rt8, "quant_paged_decode_attention")):
        eng = engine(paged, run_rt)
        if paged:
            want = 257 if run_rt.kv_dtype is None else 497
            check(eng.n_pages == want, f"{label}: equal-HBM budget "
                  f"{eng.n_pages} pages, expected {want}")
        runs[label] = drive(f"{label}, prefix cache off", eng, reqs,
                            counters, base | {kernel})
        del eng
    contig = runs["contiguous bf16 w1"]["kv_bytes"]
    for label in ("paged bf16", "contiguous int8", "paged int8"):
        kvb = runs[label]["kv_bytes"]
        print(f"[serve] kv cache {label}: {kvb} B = {kvb / contig:.4f} x "
              f"contiguous bf16 ({contig} B)")
        # the paged pools are sized to the contiguous bf16 bytes; the
        # contiguous int8 cache simply stores fewer bytes
        check(label == "contiguous int8" or abs(kvb - contig) <= 0.01 * contig,
              f"{label}: kv cache {kvb} B is not within 1 % of {contig} B")
    check(runs["paged bf16"]["streams"]
          == runs["contiguous bf16 w1"]["streams"],
          "paged bf16 token streams differ from contiguous bf16")
    check(runs["paged int8"]["streams"] == runs["contiguous int8"]["streams"],
          "paged int8 token streams differ from contiguous int8")
    print(f"[serve] paged bf16 streams == contiguous bf16; paged int8 "
          f"streams == contiguous int8 ({len(reqs)} requests x "
          f"{NEW_TOKENS} tokens each)")

    rng = np.random.default_rng(11)
    system = rng.integers(0, cfg.vocab_size, SYSTEM_LEN)
    shared = [np.concatenate([system, rng.integers(
        0, cfg.vocab_size, int(rng.integers(8, 41)))]).astype(np.int32)
        for _ in range(N_SYSTEM_REQS)]
    for prefix in (False, True):
        runs[f"prefix {prefix}"] = drive(
            f"shared {SYSTEM_LEN}-token prompt, paged bf16, prefix cache "
            f"{'on' if prefix else 'off'}", engine(True, rt, prefix=prefix),
            shared, counters, base | {"paged_decode_attention"})
    cold, warm = runs["prefix False"], runs["prefix True"]
    check(warm["stats"].prefix_hits >= 1, "prefix cache never hit")
    check(warm["stats"].prefill_tokens < cold["stats"].prefill_tokens,
          f"prefill tokens warm {warm['stats'].prefill_tokens} >= cold "
          f"{cold['stats'].prefill_tokens}")
    same = sum(a == b for rid in cold["streams"]
               for a, b in zip(cold["streams"][rid], warm["streams"][rid]))
    print(f"[serve] prefix cache: {warm['stats'].prefix_hits} hits, prefill "
          f"tokens {warm['stats'].prefill_tokens} warm vs "
          f"{cold['stats'].prefill_tokens} cold; warm tokens equal to cold "
          f"at {same}/{N_SYSTEM_REQS * NEW_TOKENS} positions (a hit "
          f"decode-feeds its tail, which rounds differently in bf16)")
    return launch_totals(runs, counters)


def launch_totals(runs, counters):
    return {name: sum(r["launches"][name] for r in runs.values())
            for name in counters}


def serve_pair(label, cfg, params, rt, counters, expect, attention):
    """One trace through ``ServeEngine`` and ``PagedServeEngine`` (page
    size 16, the equal-HBM budget, prefix cache off): the same token
    streams, and each run's launch counts. ``attention`` adds the
    contiguous and the paged decode kernel to the expected sets (a pure
    SSM model runs neither)."""
    import numpy as np
    from repro_torch.serve import PagedServeEngine, Scheduler, ServeEngine

    kw = dict(n_slots=4, max_len=1024,
              scheduler=Scheduler(cfg=cfg, max_len=1024))
    rng = np.random.default_rng(21)
    reqs = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in PROMPT_LENS]
    runs = {}
    for kind, eng, kernel in (
            ("contiguous", ServeEngine(params, cfg, rt, **kw),
             "decode_attention"),
            ("paged", PagedServeEngine(params, cfg, rt, page_size=PAGE_SIZE,
                                       prefix_cache=False, **kw),
             "paged_decode_attention")):
        runs[kind] = drive(f"{label} {kind} bf16", eng, reqs, counters,
                           expect | ({kernel} if attention else set()))
        if not attention:
            check(eng.stats.forced_tokens > 0,
                  f"{label} {kind}: no chunk-mode admission")
        del eng
    check(runs["paged"]["streams"] == runs["contiguous"]["streams"],
          f"{label}: paged token streams differ from contiguous")
    print(f"[serve] {label}: paged streams == contiguous ({len(reqs)} "
          f"requests x {NEW_TOKENS} tokens each)")
    return launch_totals(runs, counters)


def device_profile(label, step, steps=5, focus=()):
    """Wall time of ``steps`` calls of ``step`` against the device time
    of the kernels they run (torch.profiler); prints the top kernels and,
    for each name in ``focus``, the device time and launches per step of
    the kernels whose name holds it, with their share of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()                                                # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", 0.0)
        if dt > 0 and ev.device_type.name == "CUDA":
            rows.append((dt / 1e3 / steps, ev.count / steps, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"[profile] {label}: {wall_ms:.2f} ms wall, {busy:.3f} ms device "
          f"busy ({busy / wall_ms:.1%}), idle share {1 - busy / wall_ms:.1%}; "
          f"{sum(r[1] for r in rows):.0f} kernels per step")
    for ms, n, key in rows[:8]:
        print(f"[profile]   {ms:8.4f} ms/step  {n:6.0f}x  {key[:90]}")
    for name in focus:
        mine = [r for r in rows if name in r[2]]
        check(bool(mine), f"{label}: no {name} kernel in the profile")
        ms = sum(r[0] for r in mine)
        print(f"[profile]   {name}: {ms:.3f} ms/step, "
              f"{sum(r[1] for r in mine):.0f} launches/step, "
              f"{ms / busy:.1%} of device busy")


def profile_model(label, cfg, params, rt, prefill_focus=(),
                  decode_focus=()):
    """One 1024-token prefill (wall time, then its device profile) and
    the device profile of a full-width contiguous decode step, 4 slots
    at positions 512-516, with the shares of the kernels named in
    ``prefill_focus`` and ``decode_focus`` (device_profile). Returns the
    4 prompts and their next tokens."""
    import torch
    from repro_torch.models import decode_step, prefill

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    with torch.no_grad():
        toks = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                             device=dev)
        prefill(params, cfg, {"tokens": toks}, 1024, rt)      # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, cfg, {"tokens": toks}, 1024, rt)
        torch.cuda.synchronize()
        print(f"[profile] {label} prefill B1 S1024: "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms wall")
        device_profile(f"{label} prefill B1 S1024", lambda: prefill(
            params, cfg, {"tokens": toks}, 1024, rt), steps=3,
            focus=prefill_focus)
        toks = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen,
                             device=dev)
        nxt = toks[:, -1]
        cache, _ = prefill(params, cfg, {"tokens": toks}, 1024, rt)
        device_profile(f"{label} decode step B4 at pos 512-516, contiguous "
                       f"bf16", lambda: decode_step(params, cfg, cache, nxt,
                                                    rt),
                       focus=decode_focus)
    return toks, nxt


def profile_phase(cfg, params, rt):
    """Where a full-width minicpm-2b decode step's time goes, contiguous
    bf16 and paged int8 (4 slots at positions 512-516), plus one
    1024-token prefill."""
    import dataclasses
    import torch
    from repro_torch.models import (decode_step_paged, init_paged_cache,
                                    prefill, write_prefill_pages_quant)

    dev = torch.device("cuda")
    toks, nxt = profile_model(cfg.name, cfg, params, rt,
                              decode_focus=(BF16_KERNEL,))
    with torch.no_grad():
        # paged int8: each slot's 64 pages, rows written through its table
        rt8 = dataclasses.replace(rt, kv_dtype="int8")
        single, _ = prefill(params, cfg, {"tokens": toks}, 1024, rt8)
        npp = PAGES_PER_SEQ
        cache = init_paged_cache(cfg, 4, 4 * npp + 1, PAGE_SIZE, 1024,
                                 rt.dtype, "int8", device=dev)
        cache["pt"].copy_(torch.arange(1, 4 * npp + 1, device=dev)
                          .reshape(4, npp))
        write_prefill_pages_quant(
            cache["kp"], cache["vp"], cache["ks"], cache["vs"], single["k"],
            single["v"], single["ks"], single["vs"], cache["pt"],
            page_size=PAGE_SIZE)
        cache["pos"].copy_(single["pos"])
        del single
        device_profile(f"{cfg.name} decode step B4 at pos 512-516, paged "
                       f"int8", lambda: decode_step_paged(
                           params, cfg, cache, nxt, rt8,
                           page_size=PAGE_SIZE, window=1024),
                       focus=(INT8_KERNEL,))


# ===========================================================================
# Phase 4: logit parity, cuda vs torch policy
# ===========================================================================
def parity_inputs(cfg, seed, lengths=(300, 177), steps=8):
    """Two 300-token prompts (real lengths ``lengths``, or exact when
    None) and ``steps`` teacher-forced tokens per sequence."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (2, 300), generator=gen,
                         device=dev)
    forced = torch.randint(0, cfg.vocab_size, (steps, 2), generator=gen,
                           device=dev)
    if lengths is not None:
        lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return toks, lengths, forced


def cuda_vs_torch(params, cfg, inputs, on_policy=None, **rt_kw):
    """Teacher-forced logits (steps + 1, B, V) f32 under the ``cuda`` and
    the ``torch`` policy: prefill, then decode steps fed the forced
    tokens. ``on_policy(name)`` runs before each policy's pass."""
    import torch
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.models import ModelRuntime, decode_step, prefill

    toks, lengths, forced = inputs
    logs = []
    for pol in ("cuda", "torch"):
        rt = ModelRuntime(kernels=getattr(KernelPolicy, pol)(), **rt_kw)
        if on_policy is not None:
            on_policy(pol)
        with torch.no_grad():
            cache, log = prefill(params, cfg, {"tokens": toks}, 1024, rt,
                                 lengths=lengths)
            out = [log.float()]
            for t in range(forced.shape[0]):
                cache, log = decode_step(params, cfg, cache, forced[t], rt)
                out.append(log.float())
        logs.append(torch.stack(out))
        del cache
    for pol, lg in zip(("cuda", "torch"), logs):
        check(tuple(lg.shape) == (forced.shape[0] + 1, toks.shape[0],
                                  cfg.vocab_size),
              f"{cfg.name} {pol}: logit shape {tuple(lg.shape)}")
        check(bool(torch.isfinite(lg).all()),
              f"{cfg.name} {pol}: non-finite logits")
    return logs


def agreement(a, b) -> str:
    return (f"max|dlogit| {float((a - b).abs().max()):.4f}, max|logit| "
            f"{float(b.abs().max()):.3f}, argmax agreement "
            f"{float((a.argmax(-1) == b.argmax(-1)).float().mean()):.3f}")


def moe_parity(cfg, params):
    """qwen2-moe, cuda vs torch policy, prefill (lengths 300/177) + 8
    teacher-forced decode steps, dropless as served. Full depth in bf16
    is reported, not asserted: a 4th/5th-expert near-tie that bf16
    rounding flips moves that token's logits by more than LOGIT_TOL. The
    assertion is in f32 at full width and MOE_PARITY_LAYERS layers."""
    import dataclasses
    from repro_torch.models import ModelRuntime, init_params
    from repro_torch.models import moe as MOE

    routes = {}
    route = MOE._route

    def recording(p, xt, c):
        g, idx, aux = route(p, xt, c)
        routes[current].append(idx)
        return g, idx, aux

    def on_policy(pol):
        nonlocal current
        current = pol
        routes[pol] = []

    current = None
    inputs = parity_inputs(cfg, 17)
    MOE._route = recording
    try:
        a, b = cuda_vs_torch(params, cfg, inputs, on_policy,
                             moe_dropless=True)
    finally:
        MOE._route = route
    check(len(routes["cuda"]) == len(routes["torch"]) > 0, "route calls")
    same = sum(int((x == y).sum()) for x, y in zip(routes["cuda"],
                                                   routes["torch"]))
    total = sum(x.numel() for x in routes["cuda"])
    print(f"[parity] {cfg.name} full depth ({cfg.n_layers} layers) bf16, "
          f"prefill S300 (lengths 300/177) + 8 decode steps, cuda vs torch "
          f"(reported): {agreement(a, b)}, routing agreement {same}/{total} "
          f"(token, k) choices ({same / total:.5f})")

    small = dataclasses.replace(cfg, n_layers=MOE_PARITY_LAYERS)
    params32 = init_params(small, seed=0, rt=ModelRuntime(dtype="float32"))
    a, b = cuda_vs_torch(params32, small, inputs, dtype="float32",
                         moe_dropless=True)
    del params32
    rel = float((a - b).abs().max() / b.abs().max())
    print(f"[parity] {cfg.name} full width, {MOE_PARITY_LAYERS} layers, f32, "
          f"cuda vs torch: max|dlogit| / max|logit| {rel:.3e} (tol "
          f"{MOE_F32_RTOL:g}); {agreement(a, b)}")
    check(rel <= MOE_F32_RTOL, f"{cfg.name} f32 relative logit error {rel}")


def ssm_parity(cfg, params):
    """mamba2, cuda vs torch policy, exact-length prefill (a recurrent
    state takes no pad) + 8 teacher-forced decode steps, bf16."""
    a, b = cuda_vs_torch(params, cfg, parity_inputs(cfg, 19, lengths=None))
    dev_max = float((a - b).abs().max())
    per_step = " ".join(f"{float((x - y).abs().max()):.4f}"
                        for x, y in zip(a, b))
    print(f"[parity] {cfg.name} full depth ({cfg.n_layers} layers) bf16, "
          f"prefill S300 + 8 decode steps, cuda vs torch: {agreement(a, b)} "
          f"(tol {LOGIT_TOL}); max|dlogit| by step: {per_step}")
    check(dev_max <= LOGIT_TOL, f"{cfg.name} max|dlogit| {dev_max} > "
          f"{LOGIT_TOL}")


def parity_phase(cfg, params):
    """minicpm-2b: cuda vs torch teacher-forced logits, then the port's
    ``logit_parity`` for bf16 vs int8 KV and for int8 KV under both
    policies, on the same prompts."""
    import dataclasses
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.kernels.quant import QUANT_PARITY_TOL
    from repro_torch.models import ModelRuntime
    from repro_torch.serve import logit_parity

    inputs = parity_inputs(cfg, 7)
    a, b = cuda_vs_torch(params, cfg, inputs)
    dev_max = float((a - b).abs().max())
    print(f"[parity] {cfg.name} prefill S=300 (lengths 300/177) + 8 decode "
          f"steps, bf16: {agreement(a, b)} (tol {LOGIT_TOL})")
    check(dev_max <= LOGIT_TOL, f"max|dlogit| {dev_max} > {LOGIT_TOL}")

    rows = inputs[0].cpu().numpy()
    prompts = [rows[0, :300], rows[1, :177]]
    rt = ModelRuntime()
    rt8 = dataclasses.replace(rt, kv_dtype="int8")
    for label, ref, test in (
            ("bf16 KV vs int8 KV, cuda policy", rt, rt8),
            ("int8 KV, torch vs cuda policy",
             dataclasses.replace(rt8, kernels=KernelPolicy.torch()), rt8)):
        report = logit_parity(params, cfg, prompts, rt_ref=ref,
                              rt_test=test, max_new_tokens=8, max_len=1024)
        print(f"[parity] logit_parity {label}: "
              f"{json.dumps(report.to_json())}")
        check(report.max_logit_dev <= QUANT_PARITY_TOL,
              f"{label}: max_logit_dev {report.max_logit_dev} > "
              f"{QUANT_PARITY_TOL}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs only "
              "on an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gemm import grouped_gemm_padded
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.quant import (quant_decode_attention,
                                           quant_matmul,
                                           quant_paged_decode_attention)
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models import ModelRuntime, cast_params, init_params

    # f32 comparisons must be full f32 (the defaults, set explicitly)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- phase 1 ---------------------------------------------------------
    print(f"[device] {torch.cuda.get_device_name(0)}; count "
          f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    smi = smi_line()
    print(f"[device] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    lib_path = _build.build_library()
    _build.library()
    print(f"[build] {lib_path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    build_log = (lib_path.parent / "build.log").read_text()
    for line in build_log.splitlines():
        spills = re.search(r"(\d+) bytes spill stores", line)
        if "registers" in line or (spills and int(spills.group(1))):
            print(f"[build] {line.strip()}")
    ptxas = _build.ptxas_entries(build_log)
    for kernel in (BF16_KERNEL, INT8_KERNEL):
        split_build_lines(ptxas, kernel)
    served_build_lines(ptxas, _build.SERVED_BUILDS)

    cfg = get_arch("minicpm-2b")
    moe_cfg, ssm_cfg = get_arch("qwen2-moe-a2.7b"), get_arch("mamba2-1.3b")
    counters = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
                "decode_attention": decode_attention,
                "paged_decode_attention": paged_decode_attention,
                "quant_decode_attention": quant_decode_attention,
                "quant_paged_decode_attention": quant_paged_decode_attention,
                "moe_gemm": grouped_gemm_padded, "ssd_scan": ssd_scan,
                "quant_matmul": quant_matmul}
    # --- phase 2 ---------------------------------------------------------
    entries = kernel_phase(cfg, moe_cfg, ssm_cfg)
    tuned = tuner_phase(counters)
    gc.collect()
    torch.cuda.empty_cache()

    # --- phase 3 ---------------------------------------------------------
    t0 = time.perf_counter()
    rt = ModelRuntime()                   # bf16, cuda policy, on the card
    master = init_params(cfg, seed=0, device="cuda")
    params = cast_params(master, rt)
    del master
    torch.cuda.synchronize()
    print(f"[serve] minicpm-2b full width: {cfg.n_layers} layers, "
          f"{cfg.param_count() / 1e9:.3f} B params in bf16, seeded init "
          f"{time.perf_counter() - t0:.1f} s")
    totals = [serve_phase(cfg, params, counters, rt)]
    profile_phase(cfg, params, rt)
    # --- phase 4 ---------------------------------------------------------
    parity_phase(cfg, params)
    del params

    # --- phases 3 and 4: qwen2-moe-a2.7b, then mamba2-1.3b ----------------
    for mcfg, expect, attention in (
            (moe_cfg, {"rmsnorm", "flash_attention", "moe_gemm"}, True),
            (ssm_cfg, {"rmsnorm", "ssd_scan"}, False)):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mrt = ModelRuntime(moe_dropless=True)   # as the launcher serves
        params = init_params(mcfg, seed=0, rt=mrt)   # cast leaf by leaf
        torch.cuda.synchronize()
        print(f"[serve] {mcfg.name} full width: {mcfg.n_layers} layers, "
              f"{mcfg.param_count() / 1e9:.3f} B params in bf16, seeded "
              f"init {time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
        totals.append(serve_pair(mcfg.name, mcfg, params, mrt, counters,
                                 expect, attention))
        profile_model(mcfg.name, mcfg, params, mrt,
                      prefill_focus=(("moe_gemm",) if attention
                                     else SSD_KERNELS + ("ssd_",)),
                      decode_focus=(("moe_gemm", BF16_KERNEL) if attention
                                    else ()))
        if attention:
            moe_parity(mcfg, params)
        else:
            ssm_parity(mcfg, params)
        del params
    served = {name: sum(t[name] for t in totals) for name in counters}
    print(f"[serve] launches over all serving runs: {served}")

    # --- phase 5 ---------------------------------------------------------
    kernels = []
    for name, e in entries.items():
        e = dict(e, ok=True, launches=served[name] + tuned[name],
                 launches_by_path={"serve": served[name],
                                   "tune": tuned[name]})
        e.pop("shape")
        for t in (e, *(e[k] for k in ("d128", "prefill") if k in e)):
            for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
                check(t[key] is None or math.isfinite(t[key]),
                      f"{name} {key}")
        kernels.append(e)
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
