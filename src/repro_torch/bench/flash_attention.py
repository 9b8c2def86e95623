"""Times the flash prefill kernel on the card at the served prefill
shapes, beside its plain version, one PyTorch call and its bound.

    PYTHONPATH=src python -m repro_torch.bench.flash_attention [--iters N]
        [--only zamba2-2.7b,hubert-xlarge]

Causal self-attention at minicpm-2b's heads (B 2, S 1024, 36 heads of
64) and qwen2-moe-a2.7b's (B 1, S 1024, 16 heads of 128), in bf16 (the
tensor-core body) and f32 (the CUDA-core body); at head dim 80, the
body that equals the plain version bit for bit in both dtypes, at
zamba2-2.7b's causal prefill (B 1, S 1024, 32 heads) and hubert-xlarge's
non-causal forward (B 2, S 1024, 16 heads). Each call is timed
with CUDA events after a 256 MB write that evicts the 50 MB L2, and
the median over ``--iters`` calls is reported (the plain version's over
a tenth as many). The yardstick is ``scaled_dot_product_attention``
on the same tensors in its own head-major layout. The bound
is the larger of the bytes (q, k, v read and the output written once)
over the memory rate and the attended pairs' 4 D operations each over
the peak for the dtype (bf16 tensor cores, f32 CUDA cores); at D 80
``f32_floor_ms`` prices the operations at the f32 CUDA-core rate, and
``equal_to_plain`` says whether the output equals the plain version's
bit for bit. Prints the card's name and power limit, then one JSON
object per case. To A/B a change, run this file against the other
tree's package: ``PYTHONPATH=<other>/src python
src/repro_torch/bench/flash_attention.py``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
# after the kernels: kernels.quant imported first (as bench.quant_matmul
# does) meets kernels.dispatch's registration half-initialized
from repro_torch.bench.quant_matmul import median_ms  # noqa: E402,I100

#: (label, B, S, Hq, Hkv, D, causal) of the served prefills.
SHAPES = (("minicpm-2b", 2, 1024, 36, 36, 64, True),
          ("qwen2-moe-a2.7b", 1, 1024, 16, 16, 128, True),
          ("zamba2-2.7b", 1, 1024, 32, 32, 80, True),
          ("hubert-xlarge", 2, 1024, 16, 16, 80, False))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--only", default="",
                    help="comma-separated labels of SHAPES (default all)")
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    if not torch.cuda.is_available():
        print("flash_attention bench: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev).zero_
    for label, B, S, Hq, Hkv, D, causal in SHAPES:
        if only and label not in only:
            continue
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(B, S, h, D, generator=gen, device=dev)
                       .to(dtype) for h in (Hq, Hkv, Hkv))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            isz = q.element_size()
            nbytes = isz * (2 * q.numel() + k.numel() + v.numel())
            pairs = S * (S + 1) // 2 if causal else S * S
            ops = 4 * D * B * Hq * pairs
            peak = H100_SXM.peak_flops(str(dtype)[6:])
            bound = max(nbytes / H100_SXM.hbm_bw, ops / peak)
            row = {"model": label, "B": B, "S": S, "Hq": Hq, "Hkv": Hkv,
                   "D": D, "causal": causal, "dtype": str(dtype)[6:]}
            if D == 80:
                row["equal_to_plain"] = torch.equal(
                    flash_attention(q, k, v, causal=causal),
                    flash_attention_plain(q, k, v, causal=causal))
                row["f32_floor_ms"] = max(
                    nbytes / H100_SXM.hbm_bw,
                    ops / H100_SXM.peak_flops("float32")) * 1e3
            row.update(
                ms=median_ms(lambda: flash_attention(q, k, v, causal=causal),
                             flush, args.iters),
                plain_ms=median_ms(
                    lambda: flash_attention_plain(q, k, v, causal=causal),
                    flush, max(1, args.iters // 10)),
                library_ms=median_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal), flush, args.iters),
                bound_ms=bound * 1e3)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
