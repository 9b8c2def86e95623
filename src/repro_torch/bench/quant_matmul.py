"""Times the int8-weight matmul kernel on the card at the h100 tuner
cells' widths, beside its plain version, one PyTorch call and its bound.

    PYTHONPATH=src python -m repro_torch.bench.quant_matmul [--iters N]

Rows T 1 and 4 (decode) and 1024 (a prefill slice) at minicpm-2b's
K 2304, N 17280 and mixtral-8x22b's K 6144, N 8192, in bf16 and f32.
Each call is timed with CUDA events after a 256 MB write that evicts
the 50 MB L2, so the weight comes from device memory; the median over
``--iters`` calls is reported. The yardstick is ``torch.matmul`` of x
against the weight dequantized to x's dtype beforehand (not timed),
then the scale. Prints the card's name and power limit, then one JSON
object per case.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels.quant import (quant_matmul, quant_matmul_plain,
                                       quantize_channels)

SHAPES = ((2304, 17280), (6144, 8192))
ROWS = (1, 4, 1024)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("quant_matmul bench: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev).zero_
    for K, N in SHAPES:
        w_q, scale = quantize_channels(
            torch.randn(K, N, generator=gen, device=dev))
        for dtype in (torch.bfloat16, torch.float32):
            w_deq, sc = w_q.to(dtype), scale.to(dtype)  # exact for +-127
            for T in ROWS:
                x = torch.randn(T, K, generator=gen, device=dev).to(dtype)
                isz = x.element_size()
                nbytes = isz * T * K + K * N + 4 * N + isz * T * N
                peak = H100_SXM.peak_flops(str(dtype)[6:])
                bound = max(nbytes / H100_SXM.hbm_bw, 2 * T * K * N / peak)
                print(json.dumps({
                    "T": T, "K": K, "N": N, "dtype": str(dtype)[6:],
                    "ms": median_ms(lambda: quant_matmul(x, w_q, scale),
                                    flush, args.iters),
                    "plain_ms": median_ms(
                        lambda: quant_matmul_plain(x, w_q, scale), flush,
                        args.iters),
                    "library_ms": median_ms(
                        lambda: torch.matmul(x, w_deq) * sc, flush,
                        args.iters),
                    "bound_ms": bound * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
