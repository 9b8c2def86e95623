"""Kernel microbenchmark and autotuner of the port.

    PYTHONPATH=src python -m repro_torch.kernels.tune --preset h100
    PYTHONPATH=src python -m repro_torch.kernels.tune --preset ci --device cpu

The port's counterpart of ``repro.kernels.tune``. For every (arch,
shape) cell of the preset, the tuner

1. builds the cell's Workload IR (the port's copy of the analytic LM
   front-end) and derives one microbenchmark *case* per dispatch op the
   workload contains, with the reference's geometry and its IR-derived
   FLOP and byte counts (:func:`cases_for_cell`);
2. times every registered implementation of the op (``torch`` and
   ``cuda``, from the live table of
   :mod:`repro_torch.kernels.dispatch`) over the preset's grid;
3. writes the winners and every timing, in the reference's schema
   (version 2, ``ENTRY_FIELDS``), to the port's own artifact path,
   ``artifacts/torch/kernels/calibration.json``
   (:func:`repro_torch.artifacts.calibration_path`); the JAX tuner's
   ``artifacts/kernels/calibration.json`` is never written.

The payload's ``policy`` block maps onto ``KernelPolicy.from_calibration``
and its entries feed :class:`~repro_torch.core.analytical.measured.
MeasuredModel` and ``repro_torch.bench.kernel_model_error``.

Timing: on the card each call is timed between two CUDA events (device
time, including any gaps the host leaves between the call's kernels);
off the card with the host's ``perf_counter``. ``timer`` in the payload
says which. As the reference's, the timed calls re-use one set of
inputs, so a case whose inputs fit the card's 50 MB L2 (every decode
case) is timed L2-warm. The kernel build and the first calls fall in
the warmup.

Presets: ``ci`` is the reference's smoke grid (smoke archs, shrunken
shapes), for checking the plumbing on a CPU host (``--device cpu``, the
plain versions run; the timings mean nothing for the card). ``h100`` is
the reference ``full`` preset's six cells, in its order, at full width and the reference shapes (S 32,768), one sequence of the
global batch per case (``bench_batch`` 1) so the plain versions' f32
intermediates fit the card's 80 GB.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import torch
import torch.nn.functional as F

from repro_torch.artifacts import calibration_path
from repro_torch.configs import get_arch, get_shape, smoke_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.analytical.measured import CALIBRATION_VERSION
from repro_torch.core.workload import Workload, lm_workload
from repro_torch.kernels.dispatch import KERNEL_OPS, implementations

#: The static kernel validator of the reference (``validate=True``) has
#: no Hopper counterpart yet.
VALIDATOR_PENDING = ("the static kernel validator has no Hopper "
                     "counterpart yet (ROADMAP.md Queue 1 item 14)")


# ===========================================================================
# Presets
# ===========================================================================
@dataclass(frozen=True)
class TunePreset:
    """One scale point of the microbenchmark sweep."""

    name: str
    cells: Tuple[Tuple[str, str], ...]       # (arch, shape) pairs
    shapes: Mapping[str, ShapeConfig]        # possibly shrunken
    grids: Mapping[str, Mapping[str, Tuple[Dict[str, int], ...]]]
    shrink_archs: bool = False
    reps: int = 3
    warmup: int = 1
    # cap on the benchmarked batch (0 = the shape's global batch); the
    # IR-derived FLOP/byte counts are scaled to the slice
    bench_batch: int = 0
    # KV page sizes swept for the paged decode-attention op
    paged_page_sizes: Tuple[int, ...] = (16,)
    description: str = ""

    def arch(self, name: str) -> ModelConfig:
        cfg = get_arch(name)
        return smoke_config(cfg) if self.shrink_archs else cfg

    def shape(self, name: str) -> ShapeConfig:
        return self.shapes[name]

    def grid(self, op: str, impl: str) -> Tuple[Dict[str, int], ...]:
        return tuple(self.grids.get(op, {}).get(impl, ({},)))


def _grids(prefill_chunks, ssd_chunks):
    """The port's grids. A ``torch`` grid carries the reference's ``xla``
    grid (the plain versions honour ``chunk``). A ``cuda`` grid names only
    what the kernel honours: ``ssd_scan``'s chunk; every other kernel has
    a fixed tile (``({},)``, the default)."""
    ssd = tuple({"chunk": c} for c in ssd_chunks)
    return {
        "prefill_attention": {"torch": tuple({"chunk": c}
                                             for c in prefill_chunks)},
        "ssd_scan": {"torch": ssd, "cuda": ssd},
    }


CELLS_CI = (
    ("minicpm-2b", "prefill_32k"),       # dense attention + rmsnorm
    ("minicpm-2b", "decode_32k"),        # split-KV decode attention
    ("mamba2-1.3b", "prefill_32k"),      # SSD scan
    ("qwen2-moe-a2.7b", "prefill_32k"),  # grouped expert GEMM
)

CI = TunePreset(
    name="ci",
    cells=CELLS_CI,
    shapes={
        "prefill_32k": ShapeConfig("prefill_32k", 128, 2, "prefill"),
        "decode_32k": ShapeConfig("decode_32k", 128, 4, "decode"),
    },
    grids=_grids((64, 128), (32, 64)),
    shrink_archs=True,
    reps=3,
    warmup=1,
    paged_page_sizes=(8, 16),
    description="the reference's smoke grid, smoke archs, shrunken "
                "shapes: checks schema and plumbing (CPU: plain versions)",
)

#: The reference ``full`` preset's cells, in its order.
CELLS_FULL = (
    ("minicpm-2b", "prefill_32k"),
    ("minicpm-2b", "decode_32k"),
    ("stablelm-12b", "prefill_32k"),     # head dim 160, qk-norm
    ("mamba2-1.3b", "prefill_32k"),
    ("qwen2-moe-a2.7b", "prefill_32k"),
    ("mixtral-8x22b", "decode_32k"),
)

H100 = TunePreset(
    name="h100",
    cells=CELLS_FULL,
    shapes={
        "prefill_32k": get_shape("prefill_32k"),
        "decode_32k": get_shape("decode_32k"),
    },
    grids=_grids((512, 1024), (128, 256)),
    shrink_archs=False,
    reps=10,
    warmup=2,
    bench_batch=1,
    paged_page_sizes=(16, 64),
    description="full-width archs at the reference shapes, one sequence "
                "per case, on one H100",
)

TUNE_PRESETS: Dict[str, TunePreset] = {p.name: p for p in (CI, H100)}


# ===========================================================================
# Case derivation (Workload IR -> microbenchmark shapes)
# ===========================================================================
@dataclass
class BenchCase:
    """One (op, shape) microbenchmark derived from a workload cell."""

    op: str
    arch: str
    shape: str
    kind: str                       # train | prefill | decode
    source_op: Optional[str]        # IR op name the numbers come from
    case: Dict[str, Any]            # geometry (JSON-serializable)
    flops: float                    # per-layer work the timing covers
    bytes: float
    make_args: Callable[[], Tuple[torch.Tensor, ...]] = field(
        repr=False, default=None)
    # fixed call-site kwargs (causal, n_experts, ...) the grid params
    # are merged over
    kwargs: Dict[str, Any] = field(default_factory=dict)


def _find_op(wl: Workload, pred) -> Optional[Any]:
    for op in wl.ops:
        if pred(op):
            return op
    return None


def _generator(device: torch.device) -> torch.Generator:
    """A generator seeded 0 for inputs on ``device`` (a CPU generator for
    CPU and ``meta`` tensors)."""
    on = "cuda" if device.type == "cuda" else "cpu"
    return torch.Generator(device=on).manual_seed(0)


def cases_for_cell(cfg: ModelConfig, shape: ShapeConfig,
                   bench_batch: int = 0,
                   page_sizes: Sequence[int] = (16,),
                   device: Any = "cpu") -> List[BenchCase]:
    """The microbenchmark cases one workload cell implies, as the
    reference's ``cases_for_cell`` derives them: the Workload IR decides
    which ops exist and supplies the per-layer FLOP/byte counts, the
    ModelConfig the geometry. Inputs are drawn on ``device`` (``meta``
    gives their shapes and dtypes without memory).

    ``bench_batch`` caps the benchmarked batch; the IR op's global-batch
    counts are scaled by the slice fraction. Kept as the reference has
    them: the ``moe_gemm`` case carries a third of the expert op (the IR
    op covers three matmuls), and the ``quant_matmul`` N is recovered
    from the int8 weight bytes of the cell's largest non-expert matmul.
    """
    from repro_torch.kernels.quant import quantize_channels, quantize_rows

    dev = torch.device(device)
    wl = lm_workload(cfg, shape)
    # int8 twin of the same cell: its op records carry the reduced
    # weight/KV byte counts the quantized cases are priced at
    wl_q = lm_workload(cfg, shape, weight_dtype="int8", kv_dtype="int8")
    B_wl = shape.global_batch
    B = min(B_wl, bench_batch) if bench_batch else B_wl
    frac = B / B_wl
    S = shape.seq_len
    d = cfg.d_model
    hd, nq, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    decode = shape.kind == "decode"
    q_tokens = B if decode else B * S
    cases: List[BenchCase] = []

    def normal(g, *size):
        return torch.randn(*size, generator=g, device=dev)

    def pool_table(g, n_pool, npp):
        """A shuffled page table over pages 1..n_pool-1 (page 0 is the
        engine's null page)."""
        perm = torch.randperm(n_pool - 1, generator=g, device=dev) + 1
        return perm.to(torch.int32).reshape(B, npp)

    def pool_mask(npp, ps, W):
        return (torch.arange(npp * ps, device=dev)[None, :] < W) \
            .expand(B, npp * ps).contiguous()

    attn_op = _find_op(wl, lambda o: o.kind == "attention")
    if attn_op is not None and not decode:
        def mk_attn():
            g = _generator(dev)
            return (normal(g, B, S, nq, hd), normal(g, B, S, nkv, hd),
                    normal(g, B, S, nkv, hd))

        cases.append(BenchCase(
            "prefill_attention", cfg.name, shape.name, shape.kind,
            attn_op.name,
            {"B": B, "S": S, "Hq": nq, "Hkv": nkv, "D": hd,
             "causal": cfg.causal, "window": cfg.sliding_window},
            attn_op.flops * frac, attn_op.total_bytes * frac, mk_attn,
            kwargs={"causal": cfg.causal, "window": cfg.sliding_window}))

    if attn_op is not None and decode:
        W = shape.kv_len or S
        if cfg.sliding_window:
            W = min(W, cfg.sliding_window)

        def mk_dec(W=W):
            g = _generator(dev)
            return (normal(g, B, nq, hd), normal(g, B, W, nkv, hd),
                    normal(g, B, W, nkv, hd),
                    torch.ones((B, W), dtype=torch.bool, device=dev))

        cases.append(BenchCase(
            "decode_attention", cfg.name, shape.name, shape.kind,
            attn_op.name,
            {"B": B, "W": W, "Hq": nq, "Hkv": nkv, "D": hd},
            attn_op.flops * frac, attn_op.total_bytes * frac, mk_dec))

        # paged twin: the same attention gathered through a page table
        # over a shuffled pool, one case per preset page size
        for ps in page_sizes:
            npp = -(-W // ps)
            n_pool = B * npp + 1          # + the engine's null page 0

            def mk_paged(ps=ps, npp=npp, n_pool=n_pool, W=W):
                g = _generator(dev)
                return (normal(g, B, nq, hd), normal(g, n_pool, ps, nkv, hd),
                        normal(g, n_pool, ps, nkv, hd),
                        pool_table(g, n_pool, npp), pool_mask(npp, ps, W))

            cases.append(BenchCase(
                "paged_decode_attention", cfg.name, shape.name, shape.kind,
                attn_op.name,
                {"B": B, "W": W, "Hq": nq, "Hkv": nkv, "D": hd,
                 "page_size": ps, "n_pages": n_pool},
                attn_op.flops * frac, attn_op.total_bytes * frac, mk_paged))

        # quantized twins: int8 KV with per-row bf16 scales, priced from
        # the int8-annotated workload (payload + scale side-band)
        attn_op_q = _find_op(wl_q, lambda o: o.kind == "attention")

        def mk_qdec(W=W):
            g = _generator(dev)
            q = normal(g, B, nq, hd)
            k_q, k_s = quantize_rows(normal(g, B, W, nkv, hd))
            v_q, v_s = quantize_rows(normal(g, B, W, nkv, hd))
            return (q, k_q, v_q, k_s, v_s,
                    torch.ones((B, W), dtype=torch.bool, device=dev))

        cases.append(BenchCase(
            "quant_decode_attention", cfg.name, shape.name, shape.kind,
            attn_op_q.name,
            {"B": B, "W": W, "Hq": nq, "Hkv": nkv, "D": hd,
             "kv_dtype": "int8"},
            attn_op_q.flops * frac, attn_op_q.total_bytes * frac, mk_qdec))

        ps_q = page_sizes[0]
        npp_q = -(-W // ps_q)
        n_pool_q = B * npp_q + 1

        def mk_qpaged(ps=ps_q, npp=npp_q, n_pool=n_pool_q, W=W):
            g = _generator(dev)
            q = normal(g, B, nq, hd)
            kp_q, kp_s = quantize_rows(normal(g, n_pool, ps, nkv, hd))
            vp_q, vp_s = quantize_rows(normal(g, n_pool, ps, nkv, hd))
            return (q, kp_q, vp_q, kp_s, vp_s, pool_table(g, n_pool, npp),
                    pool_mask(npp, ps, W))

        cases.append(BenchCase(
            "quant_paged_decode_attention", cfg.name, shape.name,
            shape.kind, attn_op_q.name,
            {"B": B, "W": W, "Hq": nq, "Hkv": nkv, "D": hd,
             "page_size": ps_q, "n_pages": n_pool_q, "kv_dtype": "int8"},
            attn_op_q.flops * frac, attn_op_q.total_bytes * frac,
            mk_qpaged))

    scan_op = _find_op(wl, lambda o: o.kind == "scan")
    if scan_op is not None and not decode:
        from repro_torch.models.ssm import ssm_dims
        dims = ssm_dims(cfg)
        nh, hp, N = dims["nh"], dims["hp"], dims["N"]

        def mk_ssd(nh=nh, hp=hp, N=N):
            g = _generator(dev)
            x = normal(g, B, S, nh, hp)
            dt = F.softplus(normal(g, B, S, nh))
            A = -torch.exp(normal(g, nh) * 0.5)
            return x, dt, A, normal(g, B, S, nh, N), normal(g, B, S, nh, N)

        cases.append(BenchCase(
            "ssd_scan", cfg.name, shape.name, shape.kind, scan_op.name,
            {"B": B, "S": S, "nh": nh, "hp": hp, "N": N,
             "chunk": cfg.ssm.chunk_size},
            scan_op.flops * frac, scan_op.total_bytes * frac, mk_ssd))

    moe_op = _find_op(
        wl, lambda o: o.kind == "matmul" and o.weight_axis == "experts")
    if moe_op is not None and cfg.moe is not None:
        m = cfg.moe
        E, K, f = m.n_experts, m.experts_per_token, m.d_expert
        T = q_tokens * K                       # one row per (token, k) pair

        def mk_moe(T=T, E=E, f=f):
            g = _generator(dev)
            return (normal(g, T, d), normal(g, E, d, f),
                    torch.randint(0, E, (T,), generator=g, device=dev,
                                  dtype=torch.int32))

        cases.append(BenchCase(
            "moe_gemm", cfg.name, shape.name, shape.kind, moe_op.name,
            {"T": T, "d": d, "f": f, "E": E},
            # the IR op covers all three expert matmuls (wg/wi/wo); the
            # bench times one grouped GEMM, so it carries a third.
            # Weights are batch-independent: only the activation share
            # scales with the benched batch slice.
            moe_op.flops * frac / 3.0,
            (moe_op.weight_bytes
             + (moe_op.act_in_bytes + moe_op.act_out_bytes) * frac) / 3.0,
            mk_moe,
            kwargs={"n_experts": E}))

    # quant_matmul: the cell's largest non-expert weight matmul, stored
    # int8 with per-output-channel f32 scales; N is recovered from the
    # int8 op record's weight bytes (1 byte per element)
    qmm_op = _find_op(
        wl_q, lambda o: o.kind == "matmul" and o.weight_axis == "ffn") \
        or _find_op(
            wl_q, lambda o: o.kind == "matmul" and o.weight_axis == "heads"
            and o.weight_bytes > 0)
    if qmm_op is not None:
        N = max(1, int(round(qmm_op.weight_bytes / d)))

        def mk_qmm(N=N):
            g = _generator(dev)
            x = normal(g, q_tokens, d)
            w_q, scale = quantize_channels(normal(g, d, N))
            return x, w_q, scale

        cases.append(BenchCase(
            "quant_matmul", cfg.name, shape.name, shape.kind, qmm_op.name,
            {"T": q_tokens, "K": d, "N": N, "weight_dtype": "int8"},
            qmm_op.flops * frac,
            # weights are batch-independent; activations scale with the
            # benched slice (as in the moe_gemm case)
            qmm_op.weight_bytes
            + (qmm_op.act_in_bytes + qmm_op.act_out_bytes) * frac,
            mk_qmm))

    # rmsnorm: q_tokens rows of d; not an IR op, so its counts are
    # analytic: ~4 flops/element, read + write + scale bytes in f32
    def mk_norm():
        g = _generator(dev)
        return normal(g, q_tokens, d), normal(g, d)

    cases.append(BenchCase(
        "rmsnorm", cfg.name, shape.name, shape.kind, None,
        {"rows": q_tokens, "d": d},
        4.0 * q_tokens * d, (2.0 * q_tokens * d + d) * 4.0, mk_norm))
    if frac < 1.0:
        # provenance: IR-sourced counts were scaled to the batch slice
        for c in cases:
            if c.source_op is not None:
                c.case["global_batch"] = B_wl
                c.case["batch_scale"] = frac
    return cases


# ===========================================================================
# Timing
# ===========================================================================
def time_impl(fn: Callable, args: Tuple[torch.Tensor, ...],
              params: Dict[str, int], reps: int, warmup: int,
              fixed_kwargs: Optional[Dict[str, Any]] = None,
              ) -> Dict[str, Any]:
    """Time of one (implementation, params) pair, in seconds: ``warmup``
    untimed calls (the kernel build and first calls), then ``reps`` timed
    calls, between CUDA events for CUDA inputs and by ``perf_counter``
    otherwise. Only the tuning ``params`` are recorded: fixed call-site
    kwargs (causal, n_experts, ...) must never leak into a policy."""
    f = functools.partial(fn, **{**(fixed_kwargs or {}), **params})
    cuda = args[0].device.type == "cuda"
    for _ in range(max(1, warmup)):
        f(*args)
    times = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            f(*args)
            times.append(time.perf_counter() - t0)
    return {"params": params, "best_s": min(times),
            "mean_s": sum(times) / len(times), "times": times}


def run_case(case: BenchCase, preset: TunePreset) -> Dict[str, Any]:
    """Sweep every implementation x grid point of one case."""
    args = case.make_args()
    impls_out: Dict[str, Any] = {}
    for impl, fn in sorted(implementations(case.op).items()):
        timings = [time_impl(fn, args, dict(params), preset.reps,
                             preset.warmup, fixed_kwargs=case.kwargs)
                   for params in preset.grid(case.op, impl)]
        best = min(timings, key=lambda t: t["best_s"])
        impls_out[impl] = {"best_params": best["params"],
                           "best_s": best["best_s"], "timings": timings}
    winner = min(impls_out, key=lambda i: impls_out[i]["best_s"])
    return {
        "op": case.op, "arch": case.arch, "shape": case.shape,
        "kind": case.kind, "source_op": case.source_op, "case": case.case,
        "flops": case.flops, "bytes": case.bytes,
        "impls": impls_out, "winner": winner,
        "best_s": impls_out[winner]["best_s"],
    }


def aggregate_policy(entries: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-op winning implementation and params, minimising the total
    time over every case the op appeared in (the ``policy`` block that
    ``KernelPolicy.from_calibration`` reads)."""
    policy: Dict[str, Any] = {}
    for op in KERNEL_OPS:
        op_entries = [e for e in entries if e["op"] == op]
        if not op_entries:
            continue
        impls = set.intersection(*(set(e["impls"]) for e in op_entries))
        totals = {i: sum(e["impls"][i]["best_s"] for e in op_entries)
                  for i in impls}
        best = min(totals, key=totals.get)
        # params: from the single slowest case (the one that matters)
        anchor = max(op_entries, key=lambda e: e["impls"][best]["best_s"])
        policy[op] = {"impl": best,
                      "params": anchor["impls"][best]["best_params"],
                      "total_s": totals[best]}
    return policy


# ===========================================================================
# The sweep and its CLI
# ===========================================================================
def _card_record() -> Dict[str, str]:
    """The card's name and the name and power limit ``nvidia-smi``
    reports (a card below 700 W runs slower under load)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"name": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def run_tuning(preset: TunePreset,
               cells: Optional[Sequence[Tuple[str, str]]] = None,
               reps: Optional[int] = None,
               validate: bool = False,
               device: Any = "cuda",
               log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Run the sweep on ``device``; returns the calibration payload (not
    yet written). ``validate=True`` raises: :data:`VALIDATOR_PENDING`."""
    if validate:
        raise NotImplementedError(VALIDATOR_PENDING)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_tuning: no CUDA device on this host; the "
                           "tuner times the card (device='cpu' runs the "
                           "plain versions, for checking the plumbing)")
    if reps is not None:
        preset = dataclasses.replace(preset, reps=reps)
    on_card = dev.type == "cuda"
    entries: List[Dict[str, Any]] = []
    for arch_name, shape_name in (cells or preset.cells):
        cfg = preset.arch(arch_name)
        shape = preset.shape(shape_name)
        for case in cases_for_cell(cfg, shape,
                                   bench_batch=preset.bench_batch,
                                   page_sizes=preset.paged_page_sizes,
                                   device=dev):
            t0 = time.time()
            entry = run_case(case, preset)
            entries.append(entry)
            log(f"[tune/{preset.name}] {case.arch}/{case.shape} {case.op}: "
                f"winner={entry['winner']} "
                f"best={entry['best_s'] * 1e3:.3f} ms "
                f"({time.time() - t0:.1f}s sweep)")
    payload = {
        "version": CALIBRATION_VERSION,
        "preset": preset.name,
        "backend": "cuda" if on_card else "cpu",
        "interpret": not on_card,
        "timer": ("cuda_events: device time per call, inputs re-used "
                  "across reps (L2-warm where a case's inputs fit the "
                  "50 MB L2)" if on_card
                  else "perf_counter: host wall time per call"),
        "generated_unix": time.time(),
        "cells": [list(c) for c in (cells or preset.cells)],
        "entries": entries,
        "policy": aggregate_policy(entries),
        "validation": None,
    }
    if on_card:
        payload["device"] = _card_record()
    return payload


def write_calibration(payload: Dict[str, Any],
                      out: Optional[str] = None) -> str:
    path = out or calibration_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.kernels.tune",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="h100", choices=sorted(TUNE_PRESETS),
                    help="h100: full width on the card; ci: smoke grid "
                         "and shapes (with --device cpu on a CPU host)")
    ap.add_argument("--cells", default=None,
                    help="comma-separated arch/shape overrides, e.g. "
                         "minicpm-2b/prefill_32k,mamba2-1.3b/prefill_32k")
    ap.add_argument("--reps", type=int, default=None,
                    help="override timing repetitions")
    ap.add_argument("--out", default=None,
                    help=f"output path (default {calibration_path()})")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the inputs live and the cases run")
    args = ap.parse_args(argv)

    preset = TUNE_PRESETS[args.preset]
    cells = None
    if args.cells:
        cells = []
        for spec in args.cells.split(","):
            if "/" not in spec:
                print(f"error: cell spec {spec!r} must be arch/shape",
                      file=sys.stderr)
                return 2
            arch, shape = spec.split("/", 1)
            try:
                preset.arch(arch)
            except KeyError as e:
                print(f"error: {e.args[0]}", file=sys.stderr)
                return 2
            if shape not in preset.shapes:
                print(f"error: unknown shape {shape!r} for tune preset "
                      f"{preset.name!r}; available: "
                      f"{sorted(preset.shapes)}", file=sys.stderr)
                return 2
            cells.append((arch, shape))
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device on this host; the tuner times the card "
              "(--device cpu runs the plain versions, for checking the "
              "plumbing)", file=sys.stderr)
        return 2
    print(f"[tune/{preset.name}] static kernel validator: not run "
          f"({VALIDATOR_PENDING})")
    payload = run_tuning(preset, cells=cells, reps=args.reps,
                         device=args.device)
    path = write_calibration(payload, args.out)
    print(f"\n[tune/{preset.name}] {len(payload['entries'])} entries -> "
          f"{path} ({payload['timer']})")
    for op, choice in sorted(payload["policy"].items()):
        print(f"  {op:28s} -> {choice['impl']} {choice['params'] or ''}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
