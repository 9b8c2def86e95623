"""Times the flash prefill kernel on the card at the served prefill
shapes, beside its plain version, one PyTorch call and its bound.

    PYTHONPATH=src python -m repro_torch.bench.flash_attention [--iters N]

Causal self-attention at minicpm-2b's heads (B 2, S 1024, 36 heads of
64) and qwen2-moe-a2.7b's (B 1, S 1024, 16 heads of 128), in bf16 (the
tensor-core body) and f32 (the CUDA-core body). Each call is timed
with CUDA events after a 256 MB write that evicts the 50 MB L2, and
the median over ``--iters`` calls is reported (the plain version's over
a tenth as many). The yardstick is ``scaled_dot_product_attention``
(causal) on the same tensors in its own head-major layout. The bound
is the larger of the bytes (q, k, v read and the output written once)
over the memory rate and the causal pairs' 4 D operations each over the
peak for the dtype (bf16 tensor cores, f32 CUDA cores). Prints the
card's name and power limit, then one JSON object per case.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.bench.quant_matmul import median_ms
from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)

#: (label, B, S, Hq, Hkv, D) of the served prefills.
SHAPES = (("minicpm-2b", 2, 1024, 36, 36, 64),
          ("qwen2-moe-a2.7b", 1, 1024, 16, 16, 128))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_attention bench: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev).zero_
    for label, B, S, Hq, Hkv, D in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev)
                       .to(dtype) for h in (Hq, Hkv, Hkv))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            isz = q.element_size()
            nbytes = isz * (2 * q.numel() + k.numel() + v.numel())
            ops = 4 * D * B * Hq * S * (S + 1) // 2
            peak = H100_SXM.peak_flops(str(dtype)[6:])
            bound = max(nbytes / H100_SXM.hbm_bw, ops / peak)
            print(json.dumps({
                "model": label, "B": B, "S": S, "Hq": Hq, "Hkv": Hkv,
                "D": D, "dtype": str(dtype)[6:],
                "ms": median_ms(lambda: flash_attention(q, k, v), flush,
                                args.iters),
                "plain_ms": median_ms(lambda: flash_attention_plain(q, k, v),
                                      flush, max(1, args.iters // 10)),
                "library_ms": median_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True), flush, args.iters),
                "bound_ms": bound * 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
