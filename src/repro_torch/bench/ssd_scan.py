"""Times the chunked SSD scan kernel on the card beside its plain version
and its bound.

    PYTHONPATH=src python -m repro_torch.bench.ssd_scan \
        [--iters N] [--save FILE] [--against FILE] [--profile]

Widths: mamba2-1.3b's (64 heads of 64, state 128, chunk 256). Cases, in
bf16 and f32: one 1024-token prefill (B1 S1024), two ragged 700-token
sequences (b 2 S 700) with ``chip_smoke.py``'s inputs (x unit normals,
dt = softplus(z - 2), A = -exp(z / 2), B and C unit normals over N^(1/4)),
and the tuner's prefill_32k case (B1 S32768, unscaled normals, dt =
softplus(z), as ``kernels/tune.py`` draws them). Each call is timed with
CUDA events after a 256 MB write that evicts the 50 MB L2 and a spin
that keeps the host's launch time out of the reading; the median over
``--iters`` calls is reported (fewer for the plain version and the 32k
case). No single PyTorch call computes the scan, so there is no library
time. The bound counts x, dt, A, B, C and y once and the final state
once (not the kernel's own workspace), over the H100's HBM rate,
against the chunked algorithm's operations (causal C.B^T and M.x, the
carried term and the state update) over the card's peak for the inputs'
type: the bf16 tensor cores for bf16, the f32 CUDA cores for f32
(``cuda_core_bound_ms``, at the f32 CUDA-core rate the kernel runs at,
for both).

To compare two trees, run this file against each tree's package
(``PYTHONPATH=<tree>/src python <this file>``): ``--save`` writes every
output (the 32k case's y at every 32nd position), ``--against`` loads
another run's and reports each output's largest difference from it
(``max_diff_to_against``). ``--profile``
adds the device time per call of each kernel a call launches, from
``torch.profiler``. Prints the card's name and power limit, then one
JSON object a case.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.bench.quant_attention import kernel_ms, median_ms
from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan

NH, HP, N, CHUNK = 64, 64, 128, 256
#: (label, b, S, tuner's draw)
CASES = (("prefill", 1, 1024, False), ("ragged", 2, 700, False),
         ("tuner_32k", 1, 32768, True))


def inputs(gen, b, S, dtype, tuner, dev):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    x = rnd(b, S, NH, HP).to(dtype)
    dt = F.softplus(rnd(b, S, NH) - (0.0 if tuner else 2.0))
    A = -torch.exp(rnd(NH) * 0.5)
    scale = 1.0 if tuner else N ** 0.25
    B, C = ((rnd(b, S, NH, N) / scale).to(dtype) for _ in range(2))
    return x, dt, A, B, C


def work(b, S, itemsize):
    """(bytes, operations) the scan needs at these widths."""
    L = min(CHUNK, S)
    nc = -(-S // L)
    pairs = L * (L + 1) // 2
    ops = b * NH * nc * 2 * (pairs * N + pairs * HP + 2 * L * N * HP)
    nbytes = (itemsize * b * S * NH * (2 * HP + 2 * N) + 4 * b * S * NH
              + 4 * NH + 4 * b * NH * HP * N)
    return nbytes, ops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--save", help="write every output to this file")
    ap.add_argument("--against", help="compare with a --save file")
    ap.add_argument("--profile", action="store_true",
                    help="add each launched kernel's device time per call")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_scan bench: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev).zero_
    other = torch.load(args.against) if args.against else None
    outs = {}
    for label, b, S, tuner in CASES:
        for dtype in (torch.bfloat16, torch.float32):
            key = f"{label}/{str(dtype)[6:]}"
            args_ = inputs(gen, b, S, dtype, tuner, dev)
            y, h = ssd_scan(*args_, chunk=CHUNK)
            torch.cuda.synchronize()
            # every 32nd position of the 32k case's y, so a saved run stays
            # small
            outs[key] = (y[:, ::32 if S > 1024 else 1].cpu(), h.cpu())
            row = {"case": key, "b": b, "S": S, "nh": NH, "hp": HP, "N": N,
                   "chunk": CHUNK}
            if other is not None:
                row["max_diff_to_against"] = max(
                    float((a.float() - o.float()).abs().max())
                    for a, o in zip(outs[key], other[key]))
            nbytes, ops = work(b, S, dtype.itemsize)
            t_bytes = nbytes / H100_SXM.hbm_bw * 1e3
            cc = max(t_bytes, ops / H100_SXM.peak_flops("float32") * 1e3)
            tc = max(t_bytes, ops / H100_SXM.peak_flops("bfloat16") * 1e3)
            iters = args.iters if S <= 1024 else max(3, args.iters // 10)
            row.update(
                ms=median_ms(lambda: ssd_scan(*args_, chunk=CHUNK), flush,
                             iters),
                plain_ms=median_ms(lambda: ssd_chunked(*args_, CHUNK), flush,
                                   max(3, iters // 5)),
                bound_ms=tc if dtype == torch.bfloat16 else cc,
                cuda_core_bound_ms=cc, mbytes=nbytes / 1e6, gflop=ops / 1e9)
            if args.profile:
                row["kernel_ms"] = kernel_ms(
                    lambda: ssd_scan(*args_, chunk=CHUNK), flush, calls=5)
            print(json.dumps(row), flush=True)
            del args_, y, h
            torch.cuda.empty_cache()
    if args.save:
        torch.save(outs, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
