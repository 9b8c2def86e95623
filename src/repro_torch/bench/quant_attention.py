"""Times the four split-KV decode kernels (bf16 and int8 KV, contiguous
and paged) on the card at the served widths, beside their plain
versions, one PyTorch call and their bound.

    PYTHONPATH=src python -m repro_torch.bench.quant_attention \
        [--iters N] [--save FILE] [--against FILE] [--profile]

Heads: minicpm-2b (36 of 36, D 64) and qwen2-moe-a2.7b (16 of 16, D
128). Shapes: B 4 over a 1024-row window at ``chip_smoke.py``'s
positions (1023, 700, 300, 12) and at the serving profile's (all four
at 512, the first decode step after a 512-token prefill); the paged
kernels read 16-row pages through a table that is a seeded permutation
of a 257-page pool. q is bf16; the int8 caches hold ``quantize_rows`` of
unit normals. Each call is timed with CUDA events after a 256 MB write
that evicts the 50 MB L2 and a spin that keeps the host's launch time
out of the reading; the median over ``--iters`` calls is reported
(``--iters`` / 5 for the plain version). The yardstick is
``scaled_dot_product_attention`` with the bool mask over bf16 K/V that
were gathered and dequantized beforehand (not timed). The bound counts
q, the output, the mask, the table and the valid rows' K/V payload and
scales once, over the H100's HBM rate, against ``4 D Hq`` operations a
valid row over the peak for the stored type.

To compare two trees, run this file against each tree's package
(``PYTHONPATH=<tree>/src python <this file>``): ``--save`` writes every
output, ``--against`` loads another run's and asserts the bf16 kernels'
outputs equal it bit for bit, and reports the int8 kernels' largest
difference. ``--profile`` adds the device time per call of each kernel
a call launches (the split and merge kernels), from ``torch.profiler``.
Prints the card's name and power limit, then one JSON object a case.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from repro_torch.core.hardware import H100_SXM
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.paged_attention import (gather_pages,
                                                 paged_decode_attention,
                                                 paged_decode_attention_plain)
from repro_torch.kernels.quant import (dequantize_rows,
                                       quant_decode_attention,
                                       quant_decode_attention_plain,
                                       quant_paged_decode_attention,
                                       quant_paged_decode_attention_plain,
                                       quantize_rows)

#: (label, query heads, kv heads, head dim)
HEADS = (("minicpm-2b", 36, 36, 64), ("qwen2-moe-a2.7b", 16, 16, 128))
#: (label, each sequence's position in the 1024-row window)
SHAPES = (("chip_smoke", (1023, 700, 300, 12)),
          ("serve", (512, 512, 512, 512)))
W, PAGE_SIZE = 1024, 16


#: GPU cycles (~0.5 ms) of a spin queued after the flush: the host then
#: enqueues the call and the end event before the card reaches the start
#: event, so a call of a few microseconds is timed on the card alone.
SPIN_CYCLES = 1_000_000


def median_ms(fn, flush, iters: int) -> float:
    fn()
    times = []
    for _ in range(iters):
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


def kernel_ms(fn, flush, calls: int = 20) -> dict:
    """Device time per call of each kernel ``fn`` launches (torch.profiler,
    L2 flushed before each call; the flush's own kernel left out)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush()
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", 0.0)
        if (dt > 0 and ev.device_type.name == "CUDA"
                and "fill" not in ev.key.lower()):
            name = ev.key.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("(")[0]
            out[name] = out.get(name, 0.0) + dt / calls / 1e3
    return out


def inputs(gen, H, Hkv, D, pos, dev):
    """q, the bf16 and int8 caches, contiguous and paged, the table and
    the mask of one case."""
    B = len(pos)
    NP = W // PAGE_SIZE
    P = B * NP + 1

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    q = rnd(B, H, D).to(torch.bfloat16)
    kc, vc = (rnd(B, W, Hkv, D).to(torch.bfloat16) for _ in range(2))
    kp, vp = (rnd(P, PAGE_SIZE, Hkv, D).to(torch.bfloat16) for _ in range(2))
    kq, ks = quantize_rows(rnd(B, W, Hkv, D))
    vq, vs = quantize_rows(rnd(B, W, Hkv, D))
    kpq, kps = quantize_rows(rnd(P, PAGE_SIZE, Hkv, D))
    vpq, vps = quantize_rows(rnd(P, PAGE_SIZE, Hkv, D))
    pt = (torch.randperm(P - 1, generator=gen, device=dev) + 1) \
        .reshape(B, NP).to(torch.int32)
    mask = (torch.arange(W, device=dev)[None, :]
            <= torch.tensor(pos, device=dev)[:, None])
    return dict(q=q, kc=kc, vc=vc, kp=kp, vp=vp, kq=kq, ks=ks, vq=vq, vs=vs,
                kpq=kpq, kps=kps, vpq=vpq, vps=vps, pt=pt, mask=mask)


def kernels(x):
    """(name, int8?, kernel call, plain call, (K, V) for SDPA, table?)"""
    q, pt, mask = x["q"], x["pt"], x["mask"]

    def deq(p, s):
        return dequantize_rows(p, s).to(torch.bfloat16)

    return (
        ("decode_attention", False,
         lambda: decode_attention(q, x["kc"], x["vc"], mask),
         lambda: decode_attention_plain(q, x["kc"], x["vc"], mask),
         (x["kc"], x["vc"]), False),
        ("paged_decode_attention", False,
         lambda: paged_decode_attention(q, x["kp"], x["vp"], pt, mask),
         lambda: paged_decode_attention_plain(q, x["kp"], x["vp"], pt, mask),
         (gather_pages(x["kp"], pt), gather_pages(x["vp"], pt)), True),
        ("quant_decode_attention", True,
         lambda: quant_decode_attention(q, x["kq"], x["vq"], x["ks"],
                                        x["vs"], mask),
         lambda: quant_decode_attention_plain(q, x["kq"], x["vq"], x["ks"],
                                              x["vs"], mask),
         (deq(x["kq"], x["ks"]), deq(x["vq"], x["vs"])), False),
        ("quant_paged_decode_attention", True,
         lambda: quant_paged_decode_attention(q, x["kpq"], x["vpq"],
                                              x["kps"], x["vps"], pt, mask),
         lambda: quant_paged_decode_attention_plain(
             q, x["kpq"], x["vpq"], x["kps"], x["vps"], pt, mask),
         (deq(gather_pages(x["kpq"], pt), gather_pages(x["kps"], pt)),
          deq(gather_pages(x["vpq"], pt), gather_pages(x["vps"], pt))),
         True),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--save", help="write every output to this file")
    ap.add_argument("--against", help="compare with a --save file")
    ap.add_argument("--profile", action="store_true",
                    help="add each launched kernel's device time per call")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("quant_attention bench: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev).zero_
    other = torch.load(args.against) if args.against else None
    outs = {}
    for heads, H, Hkv, D in HEADS:
        for shape, pos in SHAPES:
            x = inputs(gen, H, Hkv, D, pos, dev)
            valid = int(x["mask"].sum())
            io = 2 * 2 * x["q"].numel() + x["mask"].numel()
            for name, int8, fn, plain, (k4, v4), paged in kernels(x):
                key = f"{heads}/{shape}/{name}"
                out = fn()
                torch.cuda.synchronize()
                outs[key] = out.cpu()
                row = {"case": key, "D": D, "Hq": H, "Hkv": Hkv,
                       "valid_rows": valid}
                if other is not None:
                    same = torch.equal(outs[key], other[key])
                    if not int8 and not same:
                        raise RuntimeError(f"{key}: bf16 output differs "
                                           f"from {args.against}")
                    row["equal_to_against"] = same
                    row["max_diff_to_against"] = float(
                        (outs[key].float() - other[key].float()).abs().max())
                row_bytes = (D + 2) if int8 else 2 * D
                nbytes = (io + 2 * valid * Hkv * row_bytes
                          + (x["pt"].numel() * 4 if paged else 0))
                peak = H100_SXM.peak_flops("int8" if int8 else "bfloat16")
                bound = max(nbytes / H100_SXM.hbm_bw, 4 * D * H * valid / peak)
                q4, m4 = x["q"][:, :, None, :], x["mask"][:, None, None, :]
                kt, vt = k4.transpose(1, 2), v4.transpose(1, 2)
                row.update(
                    ms=median_ms(fn, flush, args.iters),
                    plain_ms=median_ms(plain, flush,
                                       max(1, args.iters // 5)),
                    library_ms=median_ms(
                        lambda: F.scaled_dot_product_attention(
                            q4, kt, vt, attn_mask=m4, enable_gqa=True),
                        flush, args.iters),
                    bound_ms=bound * 1e3, mbytes=nbytes / 1e6)
                if args.profile:
                    row["kernel_ms"] = kernel_ms(fn, flush)
                print(json.dumps(row), flush=True)
            del x
            torch.cuda.empty_cache()
    if args.save:
        torch.save(outs, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
