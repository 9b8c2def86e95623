#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its results on lines of its own; any failure
raises and exits non-zero (there is no CPU or plain-version fallback):

1. device and build: the card, its power limit, the ``nvcc`` build of
   every kernel source (with ptxas' register counts);
2. every kernel of the main paths against its plain PyTorch version at
   the full-width minicpm-2b shapes, in bf16 and f32 (the int8 KV
   kernels on int8 payloads with bf16 scales), then timed with CUDA
   events (kernel, plain version, one PyTorch library call as a
   yardstick) beside the least time the card could take;
3. serving: full minicpm-2b (40 layers, bf16, seeded random weights)
   with the default ``cuda`` kernel policy, 4 slots, max_len 1024:
   ``ServeEngine`` at admit widths 1 and 2, ``PagedServeEngine`` (page
   size 16, the equal-HBM page budget) with bf16 and int8 KV, the
   contiguous engine with int8 KV, and a shared-system-prompt trace
   with the prefix cache off and on. Before each run every kernel's
   launch count is set to 0; after it the run's kernels must have
   risen and the other paths' kernels stayed at 0. Paged streams must
   equal the contiguous ones (bf16 and int8), and the warm prefix run
   must hit and prefill fewer tokens. Then a profile of full-width
   decode steps (wall time against the device time of their kernels)
   and one 1024-token prefill;
4. logit parity at full width: teacher-forced prefill + decode steps
   under the ``cuda`` and ``torch`` policies on the same weights, and
   ``logit_parity`` for bf16 vs int8 KV and for int8 KV under both
   policies;
5. one JSON line describing the kernels, the card's name and power
   limit, and last the JSON result line.

It exits non-zero without printing a result when no CUDA device is
available or the repository's ``src/`` is missing.
"""
from __future__ import annotations

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

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16_tensor": 989e12, "int8_tensor": 1979e12,
            "f32_cuda_core": 67e12}

#: f32 kernel vs plain: only the summation order differs (TF32 is off).
F32_TOL = dict(atol=5e-5, rtol=1e-5)
#: bf16: both sides compute in f32 and round once; neighbouring bf16
#: values differ by at most 2^-7 of the value.
BF16_TOL = dict(atol=1e-5, rtol=2 ** -7)
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
PAGE_SIZE, PAGES_PER_SEQ = 16, 64


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
def kernel_phase(cfg):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    H, Hkv, D, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
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
        library_call="F.rms_norm, bf16 weight",
        shape=f"x (2048, {d}) bf16")

    # --- flash prefill: B 1-2, S up to 1024, 36 heads, D 64 --------------
    for dtype in (torch.float32, torch.bfloat16):
        for B, S in ((2, 1024), (1, 700)):
            q = rnd(B, S, H, D, dtype=dtype)
            k = rnd(B, S, Hkv, D, dtype=dtype)
            v = rnd(B, S, Hkv, D, dtype=dtype)
            err = compare("flash_attention", flash_attention(q, k, v),
                          flash_attention_plain(q, k, v), dtype,
                          f"B{B} S{S} H{H} D{D} causal {str(dtype)[6:]}")
    B, S = 2, 1024
    q, k, v = (rnd(B, S, h, D, dtype=torch.bfloat16) for h in (H, Hkv, Hkv))
    pairs = S * (S + 1) // 2                   # causal (q, k) pairs
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = bound(nbytes, 4 * D * pairs * B * H, "bf16_tensor")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    entries["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:89", max_abs_err=err,
        ms=time_ms(lambda: flash_attention(q, k, v), flush=flush),
        plain_ms=time_ms(lambda: flash_attention_plain(q, k, v), iters=10,
                         flush=flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), flush=flush),
        library_call="SDPA, causal",
        shape=f"B{B} S{S} Hq{H} Hkv{Hkv} D{D} causal bf16")

    # --- split-KV decode: B 4, W 1024, 36 heads, D 64, ragged mask -------
    B, W = 4, 1024
    pos = torch.tensor(DECODE_POS, device=dev)[:, None]
    mask = torch.arange(W, device=dev)[None, :] <= pos
    for dtype in (torch.float32, torch.bfloat16):
        q = rnd(B, H, D, dtype=dtype)
        kc, vc = rnd(B, W, Hkv, D, dtype=dtype), rnd(B, W, Hkv, D,
                                                     dtype=dtype)
        err = compare("decode_attention", decode_attention(q, kc, vc, mask),
                      decode_attention_plain(q, kc, vc, mask), dtype,
                      f"B{B} W{W} H{H} D{D} {str(dtype)[6:]}")
    valid = int(mask.sum())
    nbytes = 2 * (2 * q.numel() + 2 * valid * Hkv * D) + mask.numel()
    b_ms, b_by = bound(nbytes, 4 * D * H * valid, "bf16_tensor")
    q4, k4, v4 = q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2)
    m4 = mask[:, None, None, :]
    entries["decode_attention"] = dict(
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
        library_call="SDPA, bool mask",
        shape=f"B{B} W{W} Hq{H} Hkv{Hkv} D{D} bf16, {valid} valid rows")
    entries.update(decode_variants(cfg, gen, rnd, compare, flush, mask))
    for e in entries.values():
        print(f"[time] {e['name']:<16} {e['shape']}: kernel {e['ms']:.4f} "
              f"ms, plain {e['plain_ms']:.4f} ms, library "
              f"{e['library_ms']:.4f} ms ({e['library_call']}), bound "
              f"{e['bound_ms']:.4f} ms ({e['bound_by']})")
    del scratch
    return entries


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
            library_call=lib_what, shape=shape)
    return entries


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
    totals = {name: sum(r["launches"][name] for r in runs.values())
              for name in counters}
    print(f"[serve] launches over all serving runs: {totals}")
    return totals


def device_profile(label, step, steps=5):
    """Wall time of ``steps`` calls of ``step`` against the device time
    of the kernels they run (torch.profiler); prints the top kernels."""
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


def profile_phase(cfg, params, rt):
    """Where a full-width decode step's time goes, contiguous bf16 and
    paged int8 (4 slots at positions 512-516), plus one 1024-token
    prefill."""
    import dataclasses
    import torch
    from repro_torch.models import (decode_step, decode_step_paged,
                                    init_paged_cache, prefill,
                                    write_prefill_pages_quant)

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
        print(f"[profile] prefill B1 S1024: "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms wall")
        toks = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen,
                             device=dev)
        nxt = toks[:, -1]
        cache, _ = prefill(params, cfg, {"tokens": toks}, 1024, rt)
        device_profile("decode step B4 at pos 512-516, contiguous bf16",
                       lambda: decode_step(params, cfg, cache, nxt, rt))
        del cache
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
        device_profile("decode step B4 at pos 512-516, paged int8",
                       lambda: decode_step_paged(
                           params, cfg, cache, nxt, rt8,
                           page_size=PAGE_SIZE, window=1024))


# ===========================================================================
# Phase 4: logit parity, cuda vs torch policy
# ===========================================================================
def parity_phase(cfg, params):
    import torch
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.models import ModelRuntime, decode_step, prefill

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    S, steps = 300, 8
    toks = torch.randint(0, cfg.vocab_size, (2, S), generator=gen,
                         device=dev)
    lengths = torch.tensor([300, 177], dtype=torch.int32, device=dev)
    forced = torch.randint(0, cfg.vocab_size, (steps, 2), generator=gen,
                           device=dev)
    logs = {}
    for pol in ("cuda", "torch"):
        rt = ModelRuntime(kernels=getattr(KernelPolicy, pol)())
        with torch.no_grad():
            cache, log = prefill(params, cfg, {"tokens": toks}, 1024, rt,
                                 lengths=lengths)
            out = [log.float()]
            for t in range(steps):
                cache, log = decode_step(params, cfg, cache, forced[t], rt)
                out.append(log.float())
        logs[pol] = torch.stack(out)
        del cache
    a, b = logs["cuda"], logs["torch"]
    check(tuple(a.shape) == (steps + 1, 2, cfg.vocab_size),
          f"logit shape {tuple(a.shape)}")
    check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
          "non-finite logits")
    dev_max = float((a - b).abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    print(f"[parity] prefill S={S} (lengths 300/177) + {steps} decode "
          f"steps, bf16: max|dlogit| {dev_max:.4f} (tol {LOGIT_TOL}), "
          f"max|logit| {float(b.abs().max()):.3f}, argmax agreement "
          f"{agree:.3f}")
    check(dev_max <= LOGIT_TOL, f"max|dlogit| {dev_max} > {LOGIT_TOL}")

    # the port's logit_parity: bf16 vs int8 KV, and int8 KV under the
    # cuda vs the torch policy, on the same prompts
    import dataclasses
    from repro_torch.kernels.quant import QUANT_PARITY_TOL
    from repro_torch.serve import logit_parity
    rows = toks.cpu().numpy()
    prompts = [rows[0, :300], rows[1, :177]]
    rt = ModelRuntime()
    rt8 = dataclasses.replace(rt, kv_dtype="int8")
    for label, ref, test in (
            ("bf16 KV vs int8 KV, cuda policy", rt, rt8),
            ("int8 KV, torch vs cuda policy",
             dataclasses.replace(rt8, kernels=KernelPolicy.torch()), rt8)):
        report = logit_parity(params, cfg, prompts, rt_ref=ref,
                              rt_test=test, max_new_tokens=steps,
                              max_len=1024)
        print(f"[parity] logit_parity {label}: "
              f"{json.dumps(report.to_json())}")
        check(report.max_logit_dev <= QUANT_PARITY_TOL,
              f"{label}: max_logit_dev {report.max_logit_dev} > "
              f"{QUANT_PARITY_TOL}")
    return dev_max


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
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.quant import (quant_decode_attention,
                                           quant_paged_decode_attention)
    from repro_torch.kernels.rmsnorm import rmsnorm
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
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        spills = re.search(r"(\d+) bytes spill stores", line)
        if "registers" in line or (spills and int(spills.group(1))):
            print(f"[build] {line.strip()}")

    cfg = get_arch("minicpm-2b")
    # --- phase 2 ---------------------------------------------------------
    entries = kernel_phase(cfg)

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
    counters = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
                "decode_attention": decode_attention,
                "paged_decode_attention": paged_decode_attention,
                "quant_decode_attention": quant_decode_attention,
                "quant_paged_decode_attention": quant_paged_decode_attention}
    launches = serve_phase(cfg, params, counters, rt)
    profile_phase(cfg, params, rt)

    # --- phase 4 ---------------------------------------------------------
    parity_phase(cfg, params)

    # --- phase 5 ---------------------------------------------------------
    kernels = []
    for name, e in entries.items():
        e = dict(e, ok=True, launches=launches[name])
        e.pop("shape")
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            check(e[key] is None or math.isfinite(e[key]), f"{name} {key}")
        kernels.append(e)
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
