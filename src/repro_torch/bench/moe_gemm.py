"""Times the grouped expert GEMM kernel on the card at the served MoE
widths, beside its plain version, one PyTorch call and its bound.

    PYTHONPATH=src python -m repro_torch.bench.moe_gemm [--iters N]

Cases: qwen2-moe-a2.7b (60 experts) at decode (16 rows: 4 slots x top-4)
and a 1024-token prefill (4,096 rows), gate/up 2048 -> 1408 and down
1408 -> 2048, in bf16 and f32; mixtral-8x22b decode (8 rows: 4 slots x
top-2, 8 experts, 6144 -> 16384, 1.6 GB of weights) in bf16. Rows are
routed uniformly over the experts past the first few, which get none,
and the sort's static bound leaves trailing blocks. Each call is timed
with CUDA events after a 256 MB write that evicts the 50 MB L2, so the
weights come from device memory; the median over ``--iters`` calls is
reported (``--iters`` / 5 for the plain version). The yardstick is
``torch.bmm`` over the present experts' rows, each padded to the
largest group (the layout is built beforehand and not timed). The bound
counts the real rows of x and out once and each present expert's
weight once, over the H100's HBM rate, against ``2 T d f`` operations
over its peak for the dtype. A ``glu`` line per qwen2-moe bf16 row
count times the MoE layer's ``swiglu`` over the padded layout's rows
against the same over the real rows only (gathered, then scattered
back). Prints the card's name and power limit, then one JSON object a
case.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels.moe_gemm import (BLOCK_M, block_rows,
                                          grouped_gemm_padded,
                                          grouped_gemm_padded_plain,
                                          sort_by_expert)
from repro_torch.models.layers import swiglu

#: (label, rows, d, f, experts, experts left without a row, dtypes)
BF16, F32 = torch.bfloat16, torch.float32
CASES = (
    ("qwen2-moe decode", 16, 2048, 1408, 60, 4, (BF16, F32)),
    ("qwen2-moe decode", 16, 1408, 2048, 60, 4, (BF16, F32)),
    ("qwen2-moe prefill", 4096, 2048, 1408, 60, 4, (BF16, F32)),
    ("qwen2-moe prefill", 4096, 1408, 2048, 60, 4, (BF16, F32)),
    ("mixtral-8x22b decode", 8, 6144, 16384, 8, 1, (BF16,)),
)


def median_ms(fn, flush, iters: int) -> float:
    fn()
    times = []
    for _ in range(iters):
        flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def routed(gen, T, d, E, empty, dtype, dev):
    x = torch.randn(T, d, generator=gen, device=dev).to(dtype)
    eor = torch.randint(empty, E, (T,), generator=gen, device=dev)
    xp, be, inv, Tp = sort_by_expert(x, eor, E, BLOCK_M)
    rows = block_rows(inv, Tp // BLOCK_M, BLOCK_M)
    if not bool((be == E).any()) or bool(rows[be == E].any()):
        raise RuntimeError("moe_gemm bench: no trailing block, or one "
                           "holding rows")
    return x, eor, xp, be, rows, inv


def padded_groups(x, eor):
    """The present experts and their rows as one (n, max rows, d) batch
    for ``torch.bmm``."""
    present = torch.unique(eor)
    counts = (eor[:, None] == present[None, :]).sum(0)
    xe = x.new_zeros(len(present), int(counts.max()), x.shape[1])
    for j, e in enumerate(present.tolist()):
        r = x[eor == e]
        xe[j, :len(r)] = r
    return present, xe


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("moe_gemm bench: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev).zero_
    for label, T, d, f, E, empty, dtypes in CASES:
        w32 = torch.randn(E, d, f, generator=gen, device=dev) / d ** 0.5
        for dtype in dtypes:
            w = w32.to(dtype)
            x, eor, xp, be, rows, inv = routed(gen, T, d, E, empty, dtype,
                                               dev)
            present, xe = padded_groups(x, eor)
            ws = w[present].contiguous()
            isz = x.element_size()
            used = len(present)
            nbytes = isz * (T * d + used * d * f + T * f) + 8 * len(be)
            peak = H100_SXM.peak_flops(str(dtype)[6:])
            bound = max(nbytes / H100_SXM.hbm_bw, 2 * T * d * f / peak)
            args_ = (xp, w, be, rows)
            print(json.dumps({
                "case": label, "T": T, "d": d, "f": f, "E": E,
                "experts": used, "blocks": len(be),
                "real_blocks": int((rows > 0).sum()),
                "dtype": str(dtype)[6:],
                "ms": median_ms(lambda: grouped_gemm_padded(*args_), flush,
                                args.iters),
                "plain_ms": median_ms(
                    lambda: grouped_gemm_padded_plain(*args_), flush,
                    max(1, args.iters // 5)),
                "library_ms": median_ms(lambda: torch.bmm(xe, ws), flush,
                                        args.iters),
                "bound_ms": bound * 1e3}), flush=True)
            del w, ws, xe
            if dtype is BF16 and E == 60 and d == 2048:
                g = grouped_gemm_padded(*args_)
                u = grouped_gemm_padded(*args_)

                def real_rows():
                    h = torch.empty_like(g)
                    h[inv] = swiglu(g[inv], u[inv])
                    return h

                print(json.dumps({
                    "case": f"{label} glu", "rows": T,
                    "padded_rows": g.shape[0], "f": f,
                    "padded_ms": median_ms(lambda: swiglu(g, u), flush,
                                           args.iters),
                    "real_rows_ms": median_ms(real_rows, flush,
                                              args.iters)}), flush=True)
        del w32
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
