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
   then zamba2-2.7b's shapes: the five attention kernels at its head dim
   80 (32 heads, G 1; checked in f32 and bf16 and timed, the ``d80``
   entries), the paged split-KV kernels equal to the contiguous ones bit
   for bit there (bf16 and int8 KV), flash at D 80 (the plain version's
   order), RMSNorm at d 2560 and 5120 and the SSD scan at its widths (80
   heads of 64, state 64) equal to their plain versions bit for bit;
   the timings of flash (bf16), of the grouped GEMM (bf16) and of the
   int8 matmul at T > 16 name the tensor-core body they ran
   (``mma.sync``), the four split-KV kernels', RMSNorm's and the SSD
   scan's name their body, and the grouped GEMM's checks name the body
   of each dtype (f32: the CUDA cores); the SSD scan's bound is taken at
   the bf16 tensor-core rate (the least time the card could take), with
   the f32 CUDA-core figure, its body's own unit, beside it; then the
   last-ported families' attention shapes, each checked in f32 and bf16
   and timed as the ``d80`` entries are (the ``d160``, ``g12`` and
   ``g16`` entries): stablelm-12b's head dim 160 (32 heads over 8),
   starcoder2-3b's group of 12 and chatglm3-6b's group of 16 (D 128
   over 2 kv heads); paged == contiguous bit for bit at G 16 and D 160
   (bf16 and int8 KV); RMSNorm bit for bit at d 160 (stablelm's
   qk-norm), 3584 and 4096;

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
   60 experts top-4, dropless as served), mamba2-1.3b (48 layers,
   chunk-mode admission) and the hybrid zamba2-2.7b (54 Mamba-2 layers,
   a shared attention block at head dim 80 after every 6, chunk-mode
   admission): each model through ``ServeEngine`` and
   ``PagedServeEngine`` with equal streams (zamba2 in bf16 and int8 KV,
   four engines), ``moe_gemm`` launched only in the MoE runs,
   ``ssd_scan`` only in the SSM and hybrid runs and no attention kernel
   in the SSM runs; a prefill and a decode-step profile; and
   cuda-vs-torch parity: mamba2 and zamba2 in bf16 under the same
   tolerance (zamba2 also int8 KV under both policies within
   ``QUANT_PARITY_TOL``, and bf16 vs int8 KV reported),
   qwen2-moe asserted in f32 at 4 layers and reported in bf16 at full
   depth (logits, argmax and routing agreement); mamba2's prefill profile
   shows each of the SSD scan's three kernels and their share;

   then ``[families]``, the last-ported families at full width and
   depth with seeded random bf16 weights, one model on the card at a
   time: chatglm3-6b (28 layers, 2d RoPE, G 16), starcoder2-3b (30,
   LayerNorm and GELU, G 12), stablelm-12b (40, LayerNorm, qk-norm,
   head dim 160) and qwen2-vl-7b (28, M-RoPE, G 7) each through
   ``ServeEngine`` and ``PagedServeEngine`` (equal streams; stablelm
   also in int8 KV), with its attention kernels and (but for
   starcoder2, all LayerNorm) ``rmsnorm`` launched and no other
   path's; a prefill and a decode-step profile, ``[trace]``, and cuda
   vs torch logits within ``LOGIT_TOL`` (stablelm's int8 KV under both
   policies and bf16 vs int8 KV within ``QUANT_PARITY_TOL``, as
   minicpm-2b's);
   qwen2-vl prefilled from patch embeddings (B 1, S 1024) on M-RoPE
   positions of a 32 x 32 grid, cuda vs torch; hubert-xlarge (48
   layers) ``forward`` from frame embeddings at B 2, S 1024, cuda vs
   torch, only flash (non-causal, D 80) launched, profiled, and
   refused by ``ServeEngine``; each model's and the phase's time;

   after each model's profile, ``[trace]``: the trace front-end
   (``repro_torch.core.workload.torch_trace``) at the profiled prefill
   (B1 S1024) and decode step (B 4, KV 516). The trace of the call on
   the card (the served runtime, ``cuda`` policy, launch counts set to 0
   first; the model's kernels must launch, no other path's) must equal
   the abstract trace on ``meta`` (``torch`` policy) op for op: kind, K,
   N, count, FLOPs, weight bytes. Each line, ``[trace] <arch>/<prefill|
   decode> ops <n> matmul <r> activation <r> weight-bytes <r>
   predicted(traced) <ms> predicted(analytic) <ms> device <ms>``, gives
   ``diff_workloads`` against the analytic profile (the weight-matmul
   ratio asserted within 0.05) and the one-card model's prediction on
   the traced and on the analytic workload beside the device time the
   profile measured; the phase prints its own time;
5. training (``[train]``), with the card emptied first: full-width
   minicpm-2b (40 layers, f32 master weights), one f32 loss and gradient
   at B 2, S 512 under the ``cuda`` and the ``torch`` policy (TF32 off,
   remat none; the loss within 1e-5 relative, the largest gradient
   difference over all leaves within 1e-3 of the largest gradient), then
   five bf16 AdamW steps of ``make_train_step`` at B 4, S 512 on
   ``SyntheticLMData`` with the WSD schedule (finite losses, step 0
   within 0.02 of the ``torch`` policy's; step time, tokens/s, MFU, peak
   memory) and a device profile of one step; then qwen2-moe-a2.7b at
   full width and 2 layers, dropless (the sort-once grouped GEMMs under
   autograd), mamba2-1.3b at full width and zamba2-2.7b at full width
   (its bf16 steps at B 2: AdamW's f32 state of 2.5 B parameters takes
   40 GB), each the same gradient check and two bf16 steps. Each
   cuda-policy run must launch its
   model's kernels and no decode or int8 kernel, each torch-policy run
   none; over the phase rmsnorm, flash, the grouped GEMM and the SSD
   scan must all have launched;
6. ``[explore]``, no timed run: the one-card analytic model
   (``repro_torch.core.analytical.gpu_model``, the reference's TPU model
   at one chip) at the shapes phases 3-5 ran (the served decoders of
   ``[families]`` among them): per model one line each
   for the profiled prefill (B1 S1024), the profiled decode step (B 4,
   KV 516) and the training run (its B, S 512 and layers, remat none,
   M 1), ``predicted <ms> (<dominant>) device <ms> wall <ms>
   device/predicted <x>`` (every wall unprofiled), and each training
   run's predicted footprint against ``max_memory_allocated`` (reported,
   no bar); asserted: every configuration run is predicted to fit the
   card (zamba2-2.7b's K/V, which the footprint leaves out for the
   hybrid family as the reference does, added and printed), mixtral-8x22b's
   prefill and 24-layer qwen2-moe training are predicted not to;
   ``explore_gpu`` at train_4k for the served models equals an
   exhaustive pass over its 14 points (qwen2-moe, chatglm3-6b,
   stablelm-12b and qwen2-vl-7b infeasible); paradigm 3
   (``explore_fpga``) reaches 0.99 of the better of paradigms 1 and 2 on
   vgg16 at KU115; the DSE's int8 proxy printed beside the bf16-vs-int8
   KV ``logit_parity`` measured for minicpm-2b, zamba2-2.7b and
   stablelm-12b;
7. one JSON line describing the kernels (each kernel's launches by
   path: serve, tune, train and trace), the card's name and power limit, and
   last the JSON result line.

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
#: Keys of a kernel's check and timing at another shape: the ``d128``
#: and ``d80`` entries of the attention kernels (qwen2-moe's heads,
#: zamba2-2.7b's), the ``prefill`` entry of ``moe_gemm`` and
#: ``quant_matmul``.
SUB_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "body")
SUB_ENTRIES = ("d128", "d80", "d160", "g12", "g16", "prefill")
#: The attention shapes of the last-ported families, checked and timed
#: as the ``d128`` and ``d80`` entries are: stablelm-12b's head dim 160
#: (32 heads over 8 kv heads), starcoder2-3b's group of 12 and
#: chatglm3-6b's group of 16 (D 128 over 2 kv heads).
FAMILY_SHAPES = {"d160": "stablelm-12b", "g12": "starcoder2-3b",
                 "g16": "chatglm3-6b"}
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
#: Flash's body at head dim 80 (csrc/flash_chunked.cuh): the plain
#: version's chunked loop op for op, bit for bit.
PLAIN_ORDER = "f32 CUDA cores, the plain version's order"
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
def kernel_phase(cfg, moe_cfg, ssm_cfg, hyb_cfg):
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
    # --- zamba2-2.7b: attention at D 80, RMSNorm and the scan bit for bit
    d80 = {"flash_attention": flash_entry(hyb_cfg, rnd, compare, flush,
                                          ((1, 1024), (2, 333)),
                                          body=PLAIN_ORDER),
           "decode_attention": decode_entry(hyb_cfg, rnd, compare, flush,
                                            mask),
           **decode_variants(hyb_cfg, gen, rnd, compare, flush, mask)}
    for name, e in d80.items():
        entries[name]["d80"] = {k: e[k] for k in SUB_KEYS if k in e}
    paged_equals_contiguous(hyb_cfg, gen, mask)
    bit_for_bit_at(hyb_cfg, gen, rnd)
    # --- the last-ported families: D 160, G 12 and 16 ----------------------
    from repro_torch.configs import get_arch
    for key, arch in FAMILY_SHAPES.items():
        fcfg = get_arch(arch)
        new = {"flash_attention": flash_entry(fcfg, rnd, compare, flush,
                                              ((1, 1024), (2, 333))),
               "decode_attention": decode_entry(fcfg, rnd, compare, flush,
                                                mask),
               **decode_variants(fcfg, gen, rnd, compare, flush, mask)}
        for name, e in new.items():
            entries[name][key] = {k: e[k] for k in SUB_KEYS if k in e}
    for arch in ("chatglm3-6b", "stablelm-12b"):     # G 16, D 160
        paged_equals_contiguous(get_arch(arch), gen, mask)
    rmsnorm_bit_for_bit(gen, rnd, {160: (4, 128, 2048, 32768),
                                   3584: (4, 2048), 4096: (4, 2048)})
    entries["moe_gemm"] = moe_gemm_kernel(moe_cfg, gen, rnd, compare, flush)
    entries["ssd_scan"] = ssd_scan_kernel(ssm_cfg, gen, rnd, compare, flush)
    entries["quant_matmul"] = quant_matmul_kernel(cfg, gen, rnd, compare,
                                                  flush)
    for e in entries.values():
        for label, t in (("", e), *((f"{k} ", e[k]) for k in SUB_ENTRIES
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


def flash_entry(cfg, rnd, compare, flush, shapes, body=MMA):
    """Flash prefill at ``cfg``'s heads against its plain version at each
    causal (B, S) of ``shapes`` in f32 and bf16, then timed in bf16 at
    the first; ``body`` names the bf16 body that runs."""
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
        library_call="SDPA, causal", mma=MMA, body=body,
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


def paged_equals_contiguous(cfg, gen, mask):
    """At ``cfg``'s heads, the paged split-KV kernels (bf16 and int8 KV)
    give the contiguous kernels' outputs on the same rows bit for bit:
    the pool's pages are a seeded permutation, the contiguous caches
    their gather."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_attention import (gather_pages,
                                                     paged_decode_attention)
    from repro_torch.kernels.quant import (quant_decode_attention,
                                           quant_paged_decode_attention,
                                           quantize_rows)

    dev = mask.device
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B = mask.shape[0]
    P = B * PAGES_PER_SEQ + 1
    pt = (torch.randperm(P - 1, generator=gen, device=dev) + 1) \
        .reshape(B, PAGES_PER_SEQ).to(torch.int32)
    q = torch.randn(B, H, D, generator=gen, device=dev).bfloat16()
    pools = [torch.randn(P, PAGE_SIZE, Hkv, D, generator=gen, device=dev)
             for _ in range(2)]
    kp, vp = (t.bfloat16() for t in pools)
    (kq, ks), (vq, vs) = (quantize_rows(t) for t in pools)

    def rows(t):
        return gather_pages(t, pt).contiguous()

    same = [torch.equal(paged_decode_attention(q, kp, vp, pt, mask),
                        decode_attention(q, rows(kp), rows(vp), mask)),
            torch.equal(quant_paged_decode_attention(q, kq, vq, ks, vs, pt,
                                                     mask),
                        quant_decode_attention(q, rows(kq), rows(vq),
                                               rows(ks), rows(vs), mask))]
    check(all(same), f"D {D}: paged != contiguous (bf16, int8): {same}")
    print(f"[kernels] split-KV D{D} H{H}: paged == contiguous bit for bit, "
          f"bf16 and int8 KV ok")


def rmsnorm_bit_for_bit(gen, rnd, widths):
    """RMSNorm equal to its plain version bit for bit at each width of
    ``widths`` ({d: row counts}), f32 and bf16: stablelm-12b's qk-norm
    (d 160; a decode step's 128 query rows, a prefill's 32,768),
    qwen2-vl-7b's d_model 3584 and chatglm3-6b's 4096."""
    import torch
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

    dev = torch.device("cuda")
    for d, counts in widths.items():
        s = torch.randn(d, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            for rows in counts:
                x = rnd(rows, d, dtype=dtype)
                check(torch.equal(rmsnorm(x, s), rmsnorm_plain(x, s)),
                      f"rmsnorm ({rows}, {d}) {dtype}: not bit for bit")
        print(f"[kernels] rmsnorm d {d} ({', '.join(map(str, counts))} "
              f"rows, f32 and bf16): equal to the plain version bit for "
              f"bit ok")


def bit_for_bit_at(cfg, gen, rnd):
    """Flash at ``cfg``'s heads (the parity prefill and a 1024-token one),
    RMSNorm at its widths (d_model and the Mamba-2 gated norm's d_inner;
    decode and prefill rows) and the SSD scan at its widths, each equal
    to its plain version bit for bit, bf16 and f32."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
    from repro_torch.models.ssm import ssm_dims

    dev = torch.device("cuda")
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for dtype in (torch.float32, torch.bfloat16):
        for B, S in ((2, 300), (1, 1024)):
            q, k, v = (rnd(B, S, h, D, dtype=dtype) for h in (H, Hkv, Hkv))
            check(torch.equal(flash_attention(q, k, v),
                              flash_attention_plain(q, k, v)),
                  f"flash_attention B{B} S{S} D{D} {dtype}: not bit for bit")
    print(f"[kernels] flash_attention H{H} D{D} (B2 S300, B1 S1024, f32 and "
          f"bf16): equal to the plain version bit for bit ok")
    dims = ssm_dims(cfg)
    for d in (cfg.d_model, dims["di"]):
        s = torch.randn(d, generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            for rows in (4, 2048):
                x = rnd(rows, d, dtype=dtype)
                check(torch.equal(rmsnorm(x, s), rmsnorm_plain(x, s)),
                      f"rmsnorm ({rows}, {d}) {dtype}: not bit for bit")
        print(f"[kernels] rmsnorm d {d} (4 and 2048 rows, f32 and bf16): "
              f"equal to the plain version bit for bit ok")
    nh, hp, N, L = dims["nh"], dims["hp"], dims["N"], cfg.ssm.chunk_size
    for dtype in (torch.float32, torch.bfloat16):
        for b, S in ((1, 1024), (2, 700)):
            x = rnd(b, S, nh, hp, dtype=dtype)
            dt = F.softplus(torch.randn(b, S, nh, generator=gen, device=dev)
                            - 2.0)
            A = -torch.exp(torch.randn(nh, generator=gen, device=dev) * 0.5)
            B, C = (rnd(b, S, nh, N, dtype=dtype) for _ in range(2))
            (y, h), (yw, hw) = (ssd_scan(x, dt, A, B, C, chunk=L),
                                ssd_chunked(x, dt, A, B, C, L))
            check(torch.equal(y, yw) and torch.equal(h, hw),
                  f"ssd_scan b{b} S{S} N{N} {dtype}: not bit for bit")
    print(f"[kernels] ssd_scan nh{nh} hp{hp} N{N} L{L} (b1 S1024, b2 S700, "
          f"f32 and bf16): equal to the plain version bit for bit ok")


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


def serve_pair(label, cfg, params, rt, counters, expect, attention,
               kv_dtypes=(None,)):
    """One trace through ``ServeEngine`` and ``PagedServeEngine`` (page
    size 16, the equal-HBM budget, prefix cache off) for each KV dtype
    of ``kv_dtypes`` (None: ``rt.dtype``; ``int8``): the same token
    streams, and each run's launch counts. ``attention`` adds the
    contiguous and the paged decode kernel of the KV dtype to the
    expected sets (a pure SSM model runs neither). A recurrent model
    must have admitted in chunk mode; the paged pools must hold the
    contiguous bf16 cache's bytes within 1 %."""
    import dataclasses
    import numpy as np
    from repro_torch.serve import PagedServeEngine, Scheduler, ServeEngine

    kw = dict(n_slots=4, max_len=1024,
              scheduler=Scheduler(cfg=cfg, max_len=1024))
    rng = np.random.default_rng(21)
    reqs = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in PROMPT_LENS]
    runs = {}
    for kvd in kv_dtypes:
        run_rt = dataclasses.replace(rt, kv_dtype=kvd)
        tag = kvd or "bf16"
        quant = "quant_" if kvd == "int8" else ""
        for kind, make, kernel in (
                ("contiguous", lambda: ServeEngine(params, cfg, run_rt, **kw),
                 f"{quant}decode_attention"),
                ("paged", lambda: PagedServeEngine(
                    params, cfg, run_rt, page_size=PAGE_SIZE,
                    prefix_cache=False, **kw),
                 f"{quant}paged_decode_attention")):
            eng = make()
            runs[kind, tag] = drive(
                f"{label} {kind} {tag}", eng, reqs, counters,
                expect | ({kernel} if attention else set()))
            if cfg.family in ("ssm", "hybrid"):
                check(eng.stats.forced_tokens > 0,
                      f"{label} {kind}: no chunk-mode admission")
            del eng
        check(runs["paged", tag]["streams"]
              == runs["contiguous", tag]["streams"],
              f"{label} {tag}: paged token streams differ from contiguous")
        print(f"[serve] {label}: paged {tag} streams == contiguous "
              f"({len(reqs)} requests x {NEW_TOKENS} tokens each)")
    if attention:
        contig = runs["contiguous", "bf16"]["kv_bytes"]
        for key, r in runs.items():
            print(f"[serve] kv cache {label} {key[0]} {key[1]}: "
                  f"{r['kv_bytes']} B = {r['kv_bytes'] / contig:.4f} x "
                  f"contiguous bf16")
            check(key[0] == "contiguous"
                  or abs(r["kv_bytes"] - contig) <= 0.01 * contig,
                  f"{label} {key}: kv cache {r['kv_bytes']} B is not "
                  f"within 1 % of {contig} B")
    return launch_totals(runs, counters)


def device_profile(label, step, steps=5, focus=()):
    """Wall time of ``steps`` calls of ``step`` against the device time
    of the kernels they run (torch.profiler); prints the top kernels and,
    for each name in ``focus``, the device time and launches per step of
    the kernels whose name holds it, with their share of the busy time.
    Returns the wall and device-busy ms of one call."""
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
    return {"wall_ms": wall_ms, "device_ms": busy}


#: Unprofiled decode steps timed for ``[explore]``'s wall: the profiler's
#: CPU-side recording about doubles a decode step's wall.
DECODE_WALL_STEPS = 5


def profile_model(label, cfg, params, rt, prefill_focus=(),
                  decode_focus=()):
    """One 1024-token prefill (wall time, then its device profile) and
    the device profile of a full-width contiguous decode step, 4 slots
    at positions 512-516, with the shares of the kernels named in
    ``prefill_focus`` and ``decode_focus`` (device_profile). Returns the
    4 prompts, their next tokens and the measurements ``[explore]`` reads:
    per phase, the unprofiled wall ms and the device-busy ms of one
    call."""
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
        wall_ms = (time.perf_counter() - t0) * 1e3
        print(f"[profile] {label} prefill B1 S1024: {wall_ms:.2f} ms wall")
        measured = {"prefill": dict(device_profile(
            f"{label} prefill B1 S1024", lambda: prefill(
                params, cfg, {"tokens": toks}, 1024, rt), steps=3,
            focus=prefill_focus), wall_ms=wall_ms)}
        toks = torch.randint(0, cfg.vocab_size, (4, 512), generator=gen,
                             device=dev)
        nxt = toks[:, -1]
        cache, _ = prefill(params, cfg, {"tokens": toks}, 1024, rt)

        def step():
            decode_step(params, cfg, cache, nxt, rt)

        pos0 = cache["pos"].clone()       # the step advances it in place
        step()                                                # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DECODE_WALL_STEPS):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / DECODE_WALL_STEPS
        cache["pos"].copy_(pos0)          # the profile runs at 512-516 too
        what = f"{label} decode step B4 at pos 512-516, contiguous bf16"
        print(f"[profile] {what}: {wall_ms:.2f} ms wall, unprofiled "
              f"({DECODE_WALL_STEPS} steps)")
        measured["decode"] = dict(device_profile(what, step,
                                                 focus=decode_focus),
                                  wall_ms=wall_ms)
    return toks, nxt, measured


def profile_phase(cfg, params, rt):
    """Where a full-width minicpm-2b decode step's time goes, contiguous
    bf16 and paged int8 (4 slots at positions 512-516), plus one
    1024-token prefill. Returns profile_model's measurements."""
    import dataclasses
    import torch
    from repro_torch.models import (decode_step_paged, init_paged_cache,
                                    prefill, write_prefill_pages_quant)

    dev = torch.device("cuda")
    toks, nxt, measured = profile_model(cfg.name, cfg, params, rt,
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
    return measured


def served_shapes():
    """The cells ``profile_model`` runs, as the one-card model and the
    trace front-end name them: one 1024-token prefill, and a decode step
    of 4 slots against 516 cached rows."""
    from repro_torch.configs.base import ShapeConfig
    return {"prefill": ShapeConfig("prefill_b1_s1024", 1024, 1, "prefill"),
            "decode": ShapeConfig("decode_b4_kv516", 516, 4, "decode",
                                  kv_len=516)}


# ===========================================================================
# Phase 3c: the trace front-end on the card
# ===========================================================================
#: Traced against analytic weight-matmul FLOPs: the reference's ``diff``
#: bar (``--tol``).
TRACE_MATMUL_TOL = 0.05


def trace_keys(wl):
    """What two traces must agree on, op for op: kind, name (K, N and
    count), FLOPs and weight bytes."""
    return [(o.kind, o.name, o.flops, o.weight_bytes) for o in wl.ops]


def trace_phase(cfg, params, rt, counters, measured):
    """``[trace]``: the trace front-end (``core.workload.torch_trace``) at
    the cells of :func:`served_shapes`. For each: the trace of the call
    on the card (these weights, ``rt`` as served: the ``cuda`` policy,
    every launch count set to 0 first; the model's kernels must launch
    and no other path's) must equal the abstract trace (``meta``, the
    same runtime under the ``torch`` policy) op for op; its weight-matmul
    FLOPs must be within ``TRACE_MATMUL_TOL`` of the analytic profile's
    (qwen2-moe is served dropless: its grouped GEMMs run the K T routed
    rows the profile counts); the one-card model's prediction on the
    traced workload is printed beside the analytic profile's and the
    device time ``profile_model`` measured (ms). Returns the launch
    counts and the seconds taken."""
    import dataclasses
    import torch
    from repro_torch.core.analytical import DesignPoint, GPUModel
    from repro_torch.core.workload import (diff_workloads, lm_workload,
                                           trace_workload)
    from repro_torch.kernels.dispatch import TORCH_POLICY

    t0 = time.perf_counter()
    launches = dict.fromkeys(counters, 0)
    point = DesignPoint.make(log2_m=0, quant=0)
    for phase, shape in served_shapes().items():
        label = f"{cfg.name}/{phase}"
        expect = {"rmsnorm"} if uses_rmsnorm(cfg) else set()
        if cfg.family != "ssm":
            expect.add("flash_attention" if phase == "prefill"
                       else "decode_attention")
        if cfg.family == "moe":
            expect.add("moe_gemm")
        if cfg.family in ("ssm", "hybrid") and phase == "prefill":
            expect.add("ssd_scan")
        for fn in counters.values():
            fn.launches = 0
        card = trace_workload(cfg, shape, rt=rt, params=params)
        torch.cuda.synchronize()
        got = {name: fn.launches for name, fn in counters.items()}
        for name, n in got.items():
            check((n > 0) == (name in expect), f"[trace] {label}: kernel "
                  f"{name} launched {n} times (expected: {sorted(expect)})")
            launches[name] += n
        abstract = trace_workload(
            cfg, shape, rt=dataclasses.replace(rt, kernels=TORCH_POLICY))
        check(abstract.meta["param_bytes"] == card.meta["param_bytes"],
              f"[trace] {label}: parameter bytes differ")
        check(trace_keys(card) == trace_keys(abstract),
              f"[trace] {label}: the card trace {trace_keys(card)} differs "
              f"from the abstract trace {trace_keys(abstract)}")
        d = diff_workloads(lm_workload(cfg, shape), card)
        check(abs(d["matmul_ratio"] - 1.0) <= TRACE_MATMUL_TOL,
              f"[trace] {label}: matmul_ratio {d['matmul_ratio']}")
        priced, terms = {}, []
        for src, wl in (("traced", card), ("analytic", None)):
            r = GPUModel(cfg, shape, workload=wl).evaluate(point)
            check(r.feasible and r.latency_s > 0,
                  f"[trace] {label}: {src} prediction {r}")
            priced[src] = r.latency_s * 1e3
            terms.append(f"{src} compute {r.detail.compute_s * 1e3:.3f} "
                         f"memory {r.detail.memory_s * 1e3:.3f}")
        print(f"[trace] {label} ops {len(card.ops)} matmul "
              f"{d['matmul_ratio']:.4f} activation "
              f"{d['activation_ratio']:.4f} weight-bytes "
              f"{d['weight_bytes_ratio']:.4f} predicted(traced) "
              f"{priced['traced']:.3f} predicted(analytic) "
              f"{priced['analytic']:.3f} device "
              f"{measured[phase]['device_ms']:.3f}")
        print(f"[trace] {label}: card trace == abstract trace, "
              f"{len(card.ops)} ops ({card.meta['trace_eqns']} aten ops "
              f"on the card, {abstract.meta['trace_eqns']} on meta); "
              f"terms (ms) {'; '.join(terms)}; launches {got}")
    return launches, time.perf_counter() - t0


# ===========================================================================
# Phase 4: logit parity, cuda vs torch policy
# ===========================================================================
#: The logit_parity run whose max_logit_dev ``[explore]`` prints beside
#: the DSE's int8 accuracy proxy.
INT8_KV_LABEL = "bf16 KV vs int8 KV, cuda policy"


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


def ssm_parity(cfg, params, inputs=None):
    """mamba2 (and zamba2), cuda vs torch policy, exact-length prefill (a
    recurrent state takes no pad) + 8 teacher-forced decode steps,
    bf16."""
    if inputs is None:
        inputs = parity_inputs(cfg, 19, lengths=None)
    a, b = cuda_vs_torch(params, cfg, inputs)
    dev_max = float((a - b).abs().max())
    per_step = " ".join(f"{float((x - y).abs().max()):.4f}"
                        for x, y in zip(a, b))
    print(f"[parity] {cfg.name} full depth ({cfg.n_layers} layers) bf16, "
          f"prefill S300 + 8 decode steps, cuda vs torch: {agreement(a, b)} "
          f"(tol {LOGIT_TOL}); max|dlogit| by step: {per_step}")
    check(dev_max <= LOGIT_TOL, f"{cfg.name} max|dlogit| {dev_max} > "
          f"{LOGIT_TOL}")


def hybrid_parity(cfg, params):
    """zamba2, exact-length prompts (a recurrent state takes no pad) + 8
    teacher-forced decode steps: cuda vs torch policy in bf16 within
    LOGIT_TOL; ``logit_parity`` of int8 KV under the torch and the cuda
    policy within QUANT_PARITY_TOL. bf16 vs int8 KV is reported under
    both policies, not asserted: 54 random-weight Mamba-2 layers carry
    int8 rounding past the bar in the plain versions too
    (``repro_torch.bench.logit_sensitivity``). Returns bf16 vs int8 KV's
    max_logit_dev under the cuda policy."""
    import dataclasses
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.kernels.quant import QUANT_PARITY_TOL
    from repro_torch.models import ModelRuntime
    from repro_torch.serve import logit_parity

    inputs = parity_inputs(cfg, 23, lengths=None)
    ssm_parity(cfg, params, inputs)
    rows = inputs[0].cpu().numpy()
    prompts = [rows[0], rows[1]]
    rt = ModelRuntime()
    rt8 = dataclasses.replace(rt, kv_dtype="int8")
    torch_pol = KernelPolicy.torch()
    for label, ref, test, asserted in (
            ("int8 KV, torch vs cuda policy",
             dataclasses.replace(rt8, kernels=torch_pol), rt8, True),
            (INT8_KV_LABEL, rt, rt8, False),
            ("bf16 KV vs int8 KV, torch policy",
             dataclasses.replace(rt, kernels=torch_pol),
             dataclasses.replace(rt8, kernels=torch_pol), False)):
        report = logit_parity(params, cfg, prompts, rt_ref=ref, rt_test=test,
                              max_new_tokens=8, max_len=1024)
        if label == INT8_KV_LABEL:
            int8_dev = report.max_logit_dev
        print(f"[parity] {cfg.name} logit_parity {label}, prompts S300 "
              f"(exact){'' if asserted else ' (reported)'}: "
              f"{json.dumps(report.to_json())}")
        check(not asserted or report.max_logit_dev <= QUANT_PARITY_TOL,
              f"{cfg.name} {label}: max_logit_dev {report.max_logit_dev} > "
              f"{QUANT_PARITY_TOL}")
    return int8_dev


def parity_phase(cfg, params, int8=True):
    """cuda vs torch teacher-forced logits in bf16 within LOGIT_TOL, then
    (``int8``) the port's ``logit_parity`` for bf16 vs int8 KV and for
    int8 KV under both policies, on the same prompts, each within
    QUANT_PARITY_TOL. Returns bf16 vs int8 KV's max_logit_dev, or None
    without ``int8``."""
    import dataclasses
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.kernels.quant import QUANT_PARITY_TOL
    from repro_torch.models import ModelRuntime
    from repro_torch.serve import logit_parity

    inputs = parity_inputs(cfg, 7)
    a, b = cuda_vs_torch(params, cfg, inputs)
    dev_max = float((a - b).abs().max())
    print(f"[parity] {cfg.name} ({cfg.n_layers} layers) prefill S=300 "
          f"(lengths 300/177) + 8 decode steps, bf16: {agreement(a, b)} "
          f"(tol {LOGIT_TOL})")
    check(dev_max <= LOGIT_TOL,
          f"{cfg.name} max|dlogit| {dev_max} > {LOGIT_TOL}")
    if not int8:
        return None

    rows = inputs[0].cpu().numpy()
    prompts = [rows[0, :300], rows[1, :177]]
    rt = ModelRuntime()
    rt8 = dataclasses.replace(rt, kv_dtype="int8")
    for label, ref, test in (
            (INT8_KV_LABEL, rt, rt8),
            ("int8 KV, torch vs cuda policy",
             dataclasses.replace(rt8, kernels=KernelPolicy.torch()), rt8)):
        report = logit_parity(params, cfg, prompts, rt_ref=ref,
                              rt_test=test, max_new_tokens=8, max_len=1024)
        print(f"[parity] {cfg.name} logit_parity {label}: "
              f"{json.dumps(report.to_json())}")
        check(report.max_logit_dev <= QUANT_PARITY_TOL,
              f"{cfg.name} {label}: max_logit_dev {report.max_logit_dev} > "
              f"{QUANT_PARITY_TOL}")
        if label == INT8_KV_LABEL:
            int8_dev = report.max_logit_dev
    return int8_dev


# ===========================================================================
# Phase 4b: the last-ported families
# ===========================================================================
#: The four decoders of the ``[families]`` phase (full width and depth),
#: then the audio encoder.
FAMILY_DECODERS = ("chatglm3-6b", "starcoder2-3b", "stablelm-12b",
                   "qwen2-vl-7b")
ENCODER = "hubert-xlarge"
#: qwen2-vl-7b's M-RoPE prefill: one image of 32 x 32 patches.
PATCH_GRID = 32


def uses_rmsnorm(cfg) -> bool:
    """Whether ``cfg``'s path runs the RMSNorm kernel: its block norms,
    or (stablelm-12b, a LayerNorm model) its qk-norm."""
    return cfg.norm == "rmsnorm" or cfg.qk_norm


def counted(counters, fn):
    """``fn()`` with every launch count set to 0 just before; returns its
    result and the counts just after."""
    import torch
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: c.launches for name, c in counters.items()}


def mrope_prefill(cfg, params, counters):
    """qwen2-vl-7b prefilled from patch embeddings (B 1, S 1024) with
    M-RoPE positions laid out as one image: the temporal component
    constant, height and width over a 32 x 32 grid; its last-token
    logits cuda vs torch within LOGIT_TOL. Returns the cuda run's
    launch counts."""
    import torch
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.models import ModelRuntime, prefill

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    S = PATCH_GRID * PATCH_GRID
    embeds = (torch.randn(1, S, cfg.d_model, generator=gen, device=dev)
              * 0.02).to(torch.bfloat16)
    i = torch.arange(S, dtype=torch.int32, device=dev)
    pos = torch.stack([torch.zeros_like(i), i // PATCH_GRID,
                       i % PATCH_GRID])[:, None, :]          # (3, 1, S)
    batch = {"embeds": embeds, "positions": pos}
    logs = {}
    with torch.no_grad():
        for pol in ("cuda", "torch"):
            rt = ModelRuntime(kernels=getattr(KernelPolicy, pol)())
            (_, lg), got = counted(counters,
                                   lambda: prefill(params, cfg, batch, S, rt))
            logs[pol] = lg.float()
            if pol == "cuda":
                launches = got
    for name, n in launches.items():
        check((n > 0) == (name in ("rmsnorm", "flash_attention")),
              f"{cfg.name} M-RoPE prefill: {name} launched {n} times")
    a, b = logs["cuda"], logs["torch"]
    check(tuple(a.shape) == (1, cfg.vocab_size)
          and bool(torch.isfinite(a).all()), f"{cfg.name} M-RoPE logits")
    dev_max = float((a - b).abs().max())
    print(f"[families] {cfg.name} prefill from patch embeddings B1 S{S}, "
          f"M-RoPE positions of a {PATCH_GRID} x {PATCH_GRID} grid "
          f"(temporal 0, height, width), cuda vs torch: {agreement(a, b)} "
          f"(tol {LOGIT_TOL}); launches {launches}")
    check(dev_max <= LOGIT_TOL, f"{cfg.name} M-RoPE prefill max|dlogit| "
          f"{dev_max} > {LOGIT_TOL}")
    return launches


def encoder_run(cfg, params, counters):
    """hubert-xlarge: ``forward`` from frame embeddings at B 2, S 1024
    under both policies (logits within LOGIT_TOL; the cuda run launches
    flash, non-causal at head dim 80, and no decode kernel), a device
    profile of one forward, and ``ServeEngine`` refusing the encoder.
    Returns the cuda run's launch counts."""
    import torch
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.models import ModelRuntime, forward
    from repro_torch.serve import ServeEngine

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(37)
    embeds = (torch.randn(2, 1024, cfg.d_model, generator=gen, device=dev)
              * 0.02).to(torch.bfloat16)
    logs = {}
    with torch.no_grad():
        for pol in ("cuda", "torch"):
            rt = ModelRuntime(kernels=getattr(KernelPolicy, pol)())
            (lg, _), got = counted(counters, lambda: forward(
                params, cfg, {"embeds": embeds}, rt))
            logs[pol] = lg.float()
            if pol == "cuda":
                launches = got
        rt = ModelRuntime()
        device_profile(
            f"{cfg.name} forward B2 S1024 (frames), non-causal",
            lambda: forward(params, cfg, {"embeds": embeds}, rt), steps=3,
            focus=("flash_fwd",))
    for name, n in launches.items():
        check((n > 0) == (name == "flash_attention"),
              f"{cfg.name} forward: {name} launched {n} times")
    a, b = logs["cuda"], logs["torch"]
    check(tuple(a.shape) == (2, 1024, cfg.vocab_size)
          and bool(torch.isfinite(a).all()), f"{cfg.name} logits")
    dev_max = float((a - b).abs().max())
    print(f"[families] {cfg.name} full depth ({cfg.n_layers} layers) "
          f"forward B2 S1024 from frame embeddings, non-causal flash at D "
          f"{cfg.head_dim}, cuda vs torch: {agreement(a, b)} (tol "
          f"{LOGIT_TOL}); launches {launches}")
    check(dev_max <= LOGIT_TOL, f"{cfg.name} max|dlogit| {dev_max} > "
          f"{LOGIT_TOL}")
    try:
        ServeEngine(params, cfg, ModelRuntime(), n_slots=4, max_len=1024)
    except ValueError as e:
        print(f"[families] {cfg.name} ServeEngine refuses: {e}")
    else:
        check(False, f"{cfg.name}: ServeEngine accepted an encoder")
    return launches


def families_phase(counters):
    """``[families]``: the four decoders at full width and depth with
    seeded random bf16 weights, each through ``ServeEngine`` and
    ``PagedServeEngine`` (equal streams; stablelm-12b in int8 KV too),
    a decode-step and a prefill profile, ``[trace]``, and cuda vs torch
    logit parity (stablelm's bf16 vs int8 KV and int8 KV under both
    policies); qwen2-vl's M-RoPE prefill from patch embeddings;
    hubert-xlarge's forward. Each model is freed before the next. Returns the serving launch counts,
    the trace launch counts and seconds, the decoders' profiles for
    ``[explore]`` and the measured bf16 vs int8 KV deviation."""
    import gc
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import ModelRuntime, init_params

    t_phase = time.perf_counter()
    serve, traced = [], dict.fromkeys(counters, 0)
    t_trace, measured, int8_devs = 0.0, {}, {}
    rt = ModelRuntime()                  # bf16, cuda policy, on the card
    for name in FAMILY_DECODERS + (ENCODER,):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg = get_arch(name)
        params = init_params(cfg, seed=0, rt=rt)     # cast leaf by leaf
        torch.cuda.synchronize()
        print(f"[families] {name} full width: {cfg.n_layers} layers, "
              f"{cfg.param_count() / 1e9:.3f} B params in bf16 (d_model "
              f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} of "
              f"{cfg.head_dim}), seeded init {time.perf_counter() - t0:.1f} "
              f"s, {torch.cuda.memory_allocated() / 2**30:.1f} GiB on the "
              f"card")
        if name == ENCODER:
            serve.append(encoder_run(cfg, params, counters))
        else:
            expect = {"flash_attention"} | (
                {"rmsnorm"} if uses_rmsnorm(cfg) else set())
            int8 = name == "stablelm-12b"
            serve.append(serve_pair(
                name, cfg, params, rt, counters, expect, True,
                kv_dtypes=(None, "int8") if int8 else (None,)))
            _, _, measured[name] = profile_model(
                name, cfg, params, rt, prefill_focus=("flash_fwd",),
                decode_focus=(BF16_KERNEL,))
            got, dt = trace_phase(cfg, params, rt, counters, measured[name])
            traced = {k: traced[k] + got[k] for k in counters}
            t_trace += dt
            int8_dev = parity_phase(cfg, params, int8=int8)
            if int8:
                int8_devs[name] = int8_dev
            if cfg.rope == "mrope":
                serve.append(mrope_prefill(cfg, params, counters))
        del params
        torch.cuda.synchronize()
        print(f"[families] {name}: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[families] phase {time.perf_counter() - t_phase:.1f} s")
    totals = {k: sum(r[k] for r in serve) for k in counters}
    return totals, traced, t_trace, measured, int8_devs


# ===========================================================================
# Phase 5: training
# ===========================================================================
#: Batch and length of the train phase: B 2 for the f32 gradient checks,
#: B 4 for the bf16 AdamW steps, S 512 for both.
TRAIN_CHECK_B, TRAIN_B, TRAIN_S = 2, 4, 512
#: f32, cuda vs torch policy, TF32 off: the loss within 1e-5 of itself,
#: and the largest gradient difference over all leaves within 1e-3 of
#: the largest gradient (the reference's bar for its kernels under
#: autograd, tests/test_kernel_dispatch.py).
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-3
#: bf16: step 0's loss under the cuda policy against the torch policy's
#: on the same batch (both round every activation to bf16).
TRAIN_BF16_LOSS_TOL = 0.02
#: qwen2-moe trains at full width and 2 layers: 24 layers of f32 weights
#: and AdamW state need ~229 GB, 2 layers ~28 GB.
MOE_TRAIN_LAYERS = 2
#: zamba2-2.7b's bf16 steps run at B 2: its f32 masters, moments and
#: gradients take 2.5 B x 16 bytes = 40 GB and its bf16 copies 5 GB, and
#: its activations at B 4 (54 Mamba-2 layers of d_inner 5120, scaled from
#: mamba2-1.3b's ~24 GB) would take ~34 GB more.
HYBRID_TRAIN_B = 2
#: Kernels no training path runs (the decode kernels, the int8 matmul).
TRAIN_ABSENT = ("decode_attention", "paged_decode_attention",
                "quant_decode_attention", "quant_paged_decode_attention",
                "quant_matmul")


def train_run(label, counters, expect, fn):
    """``fn()`` with every launch count set to 0 before it; afterwards the
    kernels in ``expect`` must have launched and every other kernel not.
    Returns (fn's result, the launches)."""
    import torch
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    for name, n in launches.items():
        if name in expect:
            check(n > 0, f"{label}: kernel {name} was not launched")
        else:
            check(n == 0, f"{label}: kernel {name} ran {n} times")
    return out, launches


def train_batch(cfg, b, seed):
    """``SyntheticLMData``'s lcg batch 0 (B ``b``, S ``TRAIN_S``) on the
    card."""
    import torch
    from repro_torch.data import SyntheticLMData
    data = SyntheticLMData(TRAIN_S, b, cfg.vocab_size, seed=seed)
    return {k: torch.from_numpy(v).cuda() for k, v in
            data.batch_at(0).items()}


def grad_check(label, cfg, params, counters, expect, **rt_kw):
    """One f32 loss and gradient at B ``TRAIN_CHECK_B``, S ``TRAIN_S``,
    remat none, under the cuda and the torch policy: the cuda pass runs
    ``expect``'s kernels forward (the plain versions' autograd as their
    backward), the torch pass none. Returns the cuda pass's launches."""
    import torch
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.models import ModelRuntime
    from repro_torch.train.loop import value_and_grad
    from repro_torch.tree import tree_items

    batch = train_batch(cfg, TRAIN_CHECK_B, seed=5)
    res = {}
    for pol in ("cuda", "torch"):
        rt = ModelRuntime(dtype="float32", remat="none",
                          kernels=getattr(KernelPolicy, pol)(), **rt_kw)
        res[pol], launches = train_run(
            f"{label} f32 gradients, {pol} policy", counters,
            expect if pol == "cuda" else set(),
            lambda: value_and_grad(cfg, rt, params, batch))
        if pol == "cuda":
            cuda_launches = launches
    (lc, _, gc_), (lt, _, gt) = res["cuda"], res["torch"]
    loss_rel = float((lc - lt).abs() / lt.abs())
    dmax = gmax = 0.0
    for path_c, path_t in zip(tree_items(gc_), tree_items(gt)):
        check(path_c[0] == path_t[0], f"{label}: gradient trees differ")
        a, b = path_c[1], path_t[1]
        check(bool(torch.isfinite(a).all()), f"{label}: non-finite "
              f"gradient {path_c[0]}")
        dmax = max(dmax, float((a - b).abs().max()))
        gmax = max(gmax, float(b.abs().max()))
    print(f"[train] {label} f32 B{TRAIN_CHECK_B} S{TRAIN_S}, cuda vs torch "
          f"policy: loss {float(lc):.6f} vs {float(lt):.6f}, |dloss|/|loss| "
          f"{loss_rel:.3e} (tol {TRAIN_LOSS_RTOL:g}); gradients max|dg| / "
          f"max|g| {dmax / gmax:.3e} over {len(list(tree_items(gt)))} leaves "
          f"(max|g| {gmax:.4e}, tol {TRAIN_GRAD_RTOL:g}); cuda launches "
          f"{ {k: v for k, v in cuda_launches.items() if v} }")
    check(loss_rel < TRAIN_LOSS_RTOL, f"{label}: f32 loss differs by "
          f"{loss_rel:.3e}")
    check(dmax / gmax < TRAIN_GRAD_RTOL, f"{label}: f32 gradients differ "
          f"by {dmax / gmax:.3e} of the largest")
    return cuda_launches


def train_steps(label, cfg, params, counters, expect, steps, batch=TRAIN_B,
                **rt_kw):
    """``steps`` bf16 AdamW steps of ``make_train_step`` on the f32
    masters (the launcher's runtime: remat none, the config's schedule),
    B ``batch``, S ``TRAIN_S``, on ``SyntheticLMData``'s lcg batches:
    every loss finite, step 0's within ``TRAIN_BF16_LOSS_TOL`` of the
    torch policy's on the same batch. Prints the losses, the median step
    time over steps 1.. (host clock, synchronised), tokens/s, MFU against
    the H100's bf16 dense peak, the peak memory and the launches. Returns
    (the launches, the state, the step function, a batch, the median
    step ms, the peak GiB)."""
    import dataclasses
    import torch
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.models import ModelRuntime, loss_fn
    from repro_torch.train import AdamWConfig, TrainConfig
    from repro_torch.train.loop import init_state, make_train_step
    from repro_torch.tree import tree_leaves

    rt = ModelRuntime(dtype="bfloat16", remat="none", **rt_kw)
    data = SyntheticLMData(TRAIN_S, batch, cfg.vocab_size, seed=9)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.batch_at(i).items()} for i in range(steps)]
    with torch.no_grad():
        ref_loss = float(loss_fn(params, cfg, batches[0], dataclasses.replace(
            rt, kernels=KernelPolicy.torch()))[0])
    tc = TrainConfig(opt=AdamWConfig(
        peak_lr=3e-3, warmup_steps=5, total_steps=steps,
        schedule="wsd" if cfg.lr_schedule == "wsd" else "cosine"))
    step_fn = make_train_step(cfg, rt, tc)
    state = init_state(params)
    torch.cuda.reset_peak_memory_stats()

    def run():
        losses, times = [], []
        st = state
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, m = step_fn(st, b)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return losses, times

    (losses, times), launches = train_run(f"{label} bf16 steps", counters,
                                          expect, run)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite "
          f"loss {losses}")
    d0 = abs(losses[0] - ref_loss)
    n_params = sum(t.numel() for t in tree_leaves(params))
    step_ms = statistics.median(times[1:])
    tok_s = batch * TRAIN_S / step_ms * 1e3
    mfu = 6 * n_params * batch * TRAIN_S / (step_ms / 1e3) \
        / PEAK_OPS["bf16_tensor"]
    print(f"[train] {label} bf16 AdamW, B{batch} S{TRAIN_S}, {tc.opt.schedule}"
          f": loss by step {' '.join(f'{x:.4f}' for x in losses)}; step 0 "
          f"vs torch policy {ref_loss:.4f} (|d| {d0:.4f}, tol "
          f"{TRAIN_BF16_LOSS_TOL}); step ms {' '.join(f'{t:.1f}' for t in times)}"
          f", median over steps 1-{steps - 1} {step_ms:.2f} ms, "
          f"{tok_s:.1f} tok/s, MFU {mfu:.4f} (6 x {n_params / 1e9:.3f} B "
          f"params x tokens / step / 989 TFLOP/s); peak {peak:.2f} GiB; "
          f"launches { {k: v for k, v in launches.items() if v} }")
    check(d0 <= TRAIN_BF16_LOSS_TOL, f"{label}: bf16 step-0 loss "
          f"{losses[0]} vs torch policy {ref_loss}")
    return launches, state, step_fn, batches[0], step_ms, peak


def train_phase(counters):
    """Full-width training on the card: minicpm-2b's f32 gradient check
    and five bf16 AdamW steps with a profile of one, then qwen2-moe at 2
    layers (dropless: the sort-once grouped GEMMs under autograd), mamba2
    and zamba2 (its steps at B ``HYBRID_TRAIN_B``), each a gradient check
    and two steps. Returns the launches of every cuda-policy run, summed,
    and per model the measurements ``[explore]`` reads: its config, bf16
    batch, median step ms, peak GiB and (minicpm-2b) the device-busy ms
    of the profiled step."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    totals, runs = [], []
    for name, layers, expect, steps, b, rt_kw in (
            ("minicpm-2b", None, {"rmsnorm", "flash_attention"}, 5, TRAIN_B,
             {}),
            ("qwen2-moe-a2.7b", MOE_TRAIN_LAYERS,
             {"rmsnorm", "flash_attention", "moe_gemm"}, 2, TRAIN_B,
             dict(moe_dropless=True)),
            ("mamba2-1.3b", None, {"rmsnorm", "ssd_scan"}, 2, TRAIN_B, {}),
            ("zamba2-2.7b", None, {"rmsnorm", "flash_attention", "ssd_scan"},
             2, HYBRID_TRAIN_B, {})):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_arch(name)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device="cuda")        # f32
        torch.cuda.synchronize()
        label = f"{name} ({cfg.n_layers} layers)"
        print(f"[train] {label} full width: "
              f"{sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f} B "
              f"params, f32 masters, seeded init "
              f"{time.perf_counter() - t0:.1f} s")
        totals.append(grad_check(label, cfg, params, counters, expect,
                                 **rt_kw))
        gc.collect()
        torch.cuda.empty_cache()
        launches, state, step_fn, batch, step_ms, peak = train_steps(
            label, cfg, params, counters, expect, steps, batch=b, **rt_kw)
        totals.append(launches)
        run = dict(name=name, cfg=cfg, batch=b, wall_ms=step_ms,
                   peak_gib=peak, device_ms=None)
        if name == "minicpm-2b":          # profile one step of the dense model
            holder = [state]

            def one_step():
                holder[0], _ = step_fn(holder[0], batch)

            run["device_ms"] = device_profile(
                f"{label} bf16 train step B{TRAIN_B} S{TRAIN_S}", one_step,
                steps=1, focus=("flash_fwd", "rmsnorm", "nvjet",
                                "elementwise", "reduce_kernel"))["device_ms"]
            del holder
        runs.append(run)
        del params, state, step_fn, batch
    train = {name: sum(t[name] for t in totals) for name in counters}
    for name in ("rmsnorm", "flash_attention", "moe_gemm", "ssd_scan"):
        check(train[name] > 0, f"train path: {name} never launched")
    print(f"[train] launches over all training runs: {train}; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return train, runs


# ===========================================================================
# Phase 6: the one-card model against the card; the paper's flow
# ===========================================================================
#: The one-card model's verdicts are exact to 1e-12 against an
#: exhaustive pass (tests/test_torch_gpu_model.py holds them against the
#: reference's TPU model at one chip).
DSE_RTOL = 1e-12
#: Paradigm 3 contains paradigms 1 and 2 as corner points; its seeded
#: search must reach this share of the better one (the reference's bar,
#: tests/test_dse.py).
PARADIGM3_SHARE = 0.99


def explore_phase(served, runs, int8_devs):
    """No timed run: the one-card analytic model (``gpu_model``) at the
    shapes phases 3-5 ran, beside what they measured; its feasibility
    verdicts (every configuration run fits one card, mixtral-8x22b's
    prefill and 24-layer qwen2-moe training do not); ``explore_gpu`` at
    train_4k against an exhaustive pass over its 14 points; the paper's
    paradigms 1-3 on vgg16 at KU115; the DSE's int8 accuracy proxy
    beside the measured bf16-vs-int8 KV logit deviations."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.analytical import (INT8_LOGIT_DEV_PROXY,
                                             DesignPoint, GPUModel, GPUPlan,
                                             hbm_footprint)
    from repro_torch.core.analytical.gpu_model import analyze
    from repro_torch.core.dse import (benchmark_paradigm, explore_fpga,
                                      explore_gpu)
    from repro_torch.core.hardware import KU115
    from repro_torch.core.workload import cnn_workload
    from repro_torch.models.model import cache_spec

    t0 = time.perf_counter()
    shapes = served_shapes()
    infer, train = GPUPlan(), GPUPlan(microbatches=1, remat="none")

    def line(label, phase, ana, device_ms, wall_ms):
        pred = ana.step_s * 1e3
        dev = "n/a" if device_ms is None else f"{device_ms:.3f}"
        ratio = "n/a" if device_ms is None else f"{device_ms / pred:.2f}x"
        print(f"[explore] {label} {phase} predicted {pred:.3f} ms "
              f"({ana.dominant[:-2]}) device {dev} ms wall {wall_ms:.2f} ms "
              f"device/predicted {ratio} wall/predicted "
              f"{wall_ms / pred:.2f}x")

    for name, measured in served.items():
        cfg = get_arch(name)
        for phase, shape in shapes.items():
            foot = hbm_footprint(cfg, shape, infer)
            total = foot["total"]
            if cfg.family == "hybrid":
                # hbm_footprint prices K/V only for dense, moe and vlm
                # (the reference's gap, ROADMAP.md Queue 3): add the
                # attention groups' cache as the port lays it out
                spec = cache_spec(cfg, shape.global_batch, shape.seq_len)
                kv = sum(math.prod(spec[k][0]) * spec[k][1].itemsize
                         for k in ("k", "v"))
                total += kv
                print(f"[explore] {name} {phase}: hbm_footprint prices no "
                      f"K/V for the hybrid family; its {spec['k'][0][0]} "
                      f"attention groups' bf16 K/V add {kv / 1e9:.3f} GB, "
                      f"counted in this fit check ({total / 1e9:.2f} GB)")
            check(total <= H100_SXM.hbm_bytes, f"{name} {phase} predicted "
                  f"not to fit: {total / 1e9:.1f} GB")
            line(name, phase, analyze(cfg, shape, infer),
                 measured[phase]["device_ms"], measured[phase]["wall_ms"])
    for run in runs:
        cfg = run["cfg"]
        shape = ShapeConfig(f"train_b{run['batch']}_s{TRAIN_S}", TRAIN_S,
                            run["batch"], "train")
        foot = hbm_footprint(cfg, shape, train)
        label = f"{run['name']} ({cfg.n_layers} layers) B{run['batch']}"
        check(foot["fits"], f"{label} train predicted not to fit: "
              f"{foot['total'] / 1e9:.1f} GB")
        line(label, "train", analyze(cfg, shape, train), run["device_ms"],
             run["wall_ms"])
        pred_gib = foot["total"] / 2 ** 30
        print(f"[explore] {label} train footprint predicted {pred_gib:.2f} "
              f"GiB, measured peak {run['peak_gib']:.2f} GiB "
              f"(max_memory_allocated), measured/predicted "
              f"{run['peak_gib'] / pred_gib:.2f}x")

    mixtral = hbm_footprint(get_arch("mixtral-8x22b"), shapes["prefill"],
                            infer)
    moe24 = hbm_footprint(get_arch("qwen2-moe-a2.7b"), ShapeConfig(
        f"train_b{TRAIN_B}_s{TRAIN_S}", TRAIN_S, TRAIN_B, "train"), train)
    check(not mixtral["fits"], "mixtral-8x22b prefill predicted to fit")
    check(not moe24["fits"], "24-layer qwen2-moe training predicted to fit")
    print(f"[explore] predicted not to fit one card "
          f"({H100_SXM.hbm_bytes / 1e9:.0f} GB): mixtral-8x22b prefill B1 "
          f"S1024 {mixtral['total'] / 1e9:.1f} GB; qwen2-moe-a2.7b train, "
          f"24 layers, B{TRAIN_B} S{TRAIN_S} {moe24['total'] / 1e9:.2f} GB")

    shape = SHAPES["train_4k"]
    for name in served:
        cfg = get_arch(name)
        res = explore_gpu(cfg, shape)
        model = GPUModel(cfg, shape)
        evals = [model.evaluate(DesignPoint.make(log2_m=m, quant=q))
                 for m in range(7) for q in (0, 1)]
        best = max([r.efficiency for r in evals if r.feasible] or [0.0])
        check(math.isclose(res.best_fitness, best, rel_tol=DSE_RTOL)
              or res.best_fitness == best == 0.0,
              f"explore_gpu {name}: {res.best_fitness} vs exhaustive {best}")
        if best > 0:
            quant = res.search.best_point["quant"] >= 0.5
            print(f"[explore] explore_gpu {name} train_4k: best M "
                  f"{res.best_plan.microbatches}, "
                  f"{'int8' if quant else 'bf16'}, fitness "
                  f"{res.best_fitness:.4f} (roofline fraction) = exhaustive "
                  f"best of 14; front {len(res.pareto)} points, "
                  f"{res.search.unique_evaluations} evaluations")
        else:
            print(f"[explore] explore_gpu {name} train_4k: infeasible on "
                  f"one card ({res.search.best_result.reason}); fitness 0 "
                  f"= exhaustive best of 14")

    vgg = cnn_workload("vgg16")
    p1 = benchmark_paradigm(vgg, KU115, 1, batch=1).gops
    p2 = benchmark_paradigm(vgg, KU115, 2, batch=1).gops
    res = explore_fpga(vgg, KU115, batch=1, fix_batch=True, n_particles=12,
                       n_iters=10)
    p3 = res.best_design.gops()
    check(p3 >= PARADIGM3_SHARE * max(p1, p2),
          f"paradigm 3 {p3} GOP/s < {PARADIGM3_SHARE} x max({p1}, {p2})")
    print(f"[explore] vgg16 on KU115, batch 1, analytical GOP/s: paradigm 1 "
          f"{p1:.2f}, paradigm 2 {p2:.2f}, paradigm 3 (explore_fpga, split "
          f"{res.best_design.sp}) {p3:.2f} >= {PARADIGM3_SHARE} x "
          f"{max(p1, p2):.2f}")
    print(f"[explore] INT8_LOGIT_DEV_PROXY {INT8_LOGIT_DEV_PROXY} (the DSE's "
          f"int8 charge) vs measured bf16-vs-int8 KV max_logit_dev: "
          + ", ".join(f"{n} {d:.4f}" for n, d in int8_devs.items()))
    print(f"[explore] phase {time.perf_counter() - t0:.1f} s")


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
    hyb_cfg = get_arch("zamba2-2.7b")
    counters = {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
                "decode_attention": decode_attention,
                "paged_decode_attention": paged_decode_attention,
                "quant_decode_attention": quant_decode_attention,
                "quant_paged_decode_attention": quant_paged_decode_attention,
                "moe_gemm": grouped_gemm_padded, "ssd_scan": ssd_scan,
                "quant_matmul": quant_matmul}
    # --- phase 2 ---------------------------------------------------------
    entries = kernel_phase(cfg, moe_cfg, ssm_cfg, hyb_cfg)
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
    served_measured = {cfg.name: profile_phase(cfg, params, rt)}
    traced, t_trace = trace_phase(cfg, params, rt, counters,
                                  served_measured[cfg.name])
    # --- phase 4 ---------------------------------------------------------
    int8_devs = {cfg.name: parity_phase(cfg, params)}
    del params

    # --- phases 3 and 4: qwen2-moe-a2.7b, mamba2-1.3b, zamba2-2.7b --------
    for mcfg, expect, attention in (
            (moe_cfg, {"rmsnorm", "flash_attention", "moe_gemm"}, True),
            (ssm_cfg, {"rmsnorm", "ssd_scan"}, False),
            (hyb_cfg, {"rmsnorm", "flash_attention", "ssd_scan"}, True)):
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
        hybrid = mcfg.family == "hybrid"
        totals.append(serve_pair(
            mcfg.name, mcfg, params, mrt, counters, expect, attention,
            kv_dtypes=(None, "int8") if hybrid else (None,)))
        focus = {"moe": (("moe_gemm",), ("moe_gemm", BF16_KERNEL)),
                 "ssm": (SSD_KERNELS + ("ssd_",), ()),
                 "hybrid": (SSD_KERNELS + ("ssd_", "flash_fwd"),
                            (BF16_KERNEL,))}[mcfg.family]
        _, _, served_measured[mcfg.name] = profile_model(
            mcfg.name, mcfg, params, mrt, prefill_focus=focus[0],
            decode_focus=focus[1])
        got, dt = trace_phase(mcfg, params, mrt, counters,
                              served_measured[mcfg.name])
        traced = {name: traced[name] + got[name] for name in counters}
        t_trace += dt
        int8_dev = {"moe": moe_parity, "ssm": ssm_parity,
                    "hybrid": hybrid_parity}[mcfg.family](mcfg, params)
        if int8_dev is not None:
            int8_devs[mcfg.name] = int8_dev
        del params
    # --- [families]: the last-ported families ------------------------------
    fam_served, fam_traced, dt, fam_measured, fam_int8 = families_phase(
        counters)
    totals.append(fam_served)
    traced = {name: traced[name] + fam_traced[name] for name in counters}
    t_trace += dt
    served_measured.update(fam_measured)
    int8_devs.update(fam_int8)
    served = {name: sum(t[name] for t in totals) for name in counters}
    print(f"[serve] launches over all serving runs: {served}")
    print(f"[trace] phase {t_trace:.1f} s (8 models x prefill and decode, "
          f"each traced on the card and on meta); launches {traced}")
    del totals

    # --- phase 5 ---------------------------------------------------------
    trained, train_runs = train_phase(counters)

    # --- phase 6 ---------------------------------------------------------
    explore_phase(served_measured, train_runs, int8_devs)

    # --- phase 7 ---------------------------------------------------------
    kernels = []
    for name, e in entries.items():
        e = dict(e, ok=True,
                 launches=(served[name] + tuned[name] + trained[name]
                           + traced[name]),
                 launches_by_path={"serve": served[name],
                                   "tune": tuned[name],
                                   "train": trained[name],
                                   "trace": traced[name]})
        e.pop("shape")
        for t in (e, *(e[k] for k in SUB_ENTRIES if k in e)):
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
