"""Times the RMSNorm kernel on the card at the served widths, beside its
plain version, one PyTorch call and its bound.

    PYTHONPATH=src python -m repro_torch.bench.rmsnorm \
        [--iters N] [--save FILE] [--against FILE]

Rows 4 (a decode step's slots) and 2,048 (two 1024-token prefills) at d
2048 (qwen2-moe-a2.7b, mamba2-1.3b's blocks), 2304 (minicpm-2b) and 4096
(mamba2-1.3b's gated norm); x bf16 unit normals, the f32 scale as the
models keep it, eps 1e-6. Each call is timed with CUDA events after a
256 MB write that evicts the 50 MB L2 and a spin that keeps the host's
launch time out of the reading; the median over ``--iters`` calls is
reported. The yardstick is ``F.rms_norm`` with a bf16 weight (the scale
cast beforehand, not timed). The bound reads x and the scale once and
writes the output once, over the H100's HBM rate.

To compare two trees, run this file against each tree's package
(``PYTHONPATH=<tree>/src python <this file>``): ``--save`` writes every
output, ``--against`` loads another run's and reports each output's
largest difference from it (``max_diff_to_against``) and whether it is
equal bit for bit. Prints the card's name and power limit, then one
JSON object a case.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.bench.quant_attention import median_ms
from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

WIDTHS = (2048, 2304, 4096)
ROWS = (4, 2048)
EPS = 1e-6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--save", help="write every output to this file")
    ap.add_argument("--against", help="compare with a --save file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rmsnorm bench: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev).zero_
    other = torch.load(args.against) if args.against else None
    outs = {}
    for d in WIDTHS:
        for rows in ROWS:
            key = f"rows{rows}/d{d}"
            x = torch.randn(rows, d, generator=gen, device=dev) \
                .to(torch.bfloat16)
            s = torch.randn(d, generator=gen, device=dev)
            sb = s.to(torch.bfloat16)
            out = rmsnorm(x, s, eps=EPS)
            torch.cuda.synchronize()
            outs[key] = out.cpu()
            row = {"case": key, "rows": rows, "d": d, "dtype": "bfloat16"}
            if other is not None:
                row["equal_to_against"] = torch.equal(outs[key], other[key])
                row["max_diff_to_against"] = float(
                    (outs[key].float() - other[key].float()).abs().max())
            nbytes = 2 * x.numel() * 2 + d * 4
            row.update(
                ms=median_ms(lambda: rmsnorm(x, s, eps=EPS), flush,
                             args.iters),
                plain_ms=median_ms(lambda: rmsnorm_plain(x, s, eps=EPS),
                                   flush, args.iters),
                library_ms=median_ms(lambda: F.rms_norm(x, (d,), sb, EPS),
                                     flush, args.iters),
                bound_ms=nbytes / H100_SXM.hbm_bw * 1e3,
                mbytes=nbytes / 1e6)
            print(json.dumps(row), flush=True)
    if args.save:
        torch.save(outs, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
