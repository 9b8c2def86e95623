"""How far a rounding difference travels through a full-width model on
the card: teacher-forced logits of one runtime against another.

    PYTHONPATH=src python -m repro_torch.bench.logit_sensitivity \
        [--arch zamba2-2.7b] [--depths 6,12,24,36]

Seeded random bf16 weights (``init_params(seed=0)``), two exact 300-token
prompts and 8 teacher-forced decode steps (the same tokens for both
sides). Each comparison prints one JSON object with the largest logit
difference over the 9 positions and its value by position:

* ``cuda`` vs ``torch`` policy, and the ``cuda`` policy with the
  attention ops on ``torch`` (what the other kernels add);
* the ``torch`` policy against itself with the plain flash's chunk at
  256 instead of 512: only the order of its f32 sums changes;
* bf16 vs int8 KV under each policy;
* ``cuda`` vs ``torch`` at the depths of ``--depths`` (each its own
  seeded model), and in f32 at full depth (relative to max |logit|).

A model whose logits move by more than a bar when only a sum's order
changes cannot be held to that bar by any kernel that is not equal to
its plain version bit for bit. Prints the card's name and power limit
first; refuses without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import torch

from repro_torch.configs import get_arch
from repro_torch.kernels.dispatch import KernelPolicy
from repro_torch.models import ModelRuntime, decode_step, init_params, prefill

PROMPT, STEPS, MAX_LEN = 300, 8, 1024


def forced_logits(params, cfg, rt: ModelRuntime, toks, forced):
    """(STEPS + 1, B, V) f32 logits: the prefill's, then each decode
    step's, fed the ``forced`` tokens."""
    with torch.no_grad():
        cache, log = prefill(params, cfg, {"tokens": toks}, MAX_LEN, rt)
        out = [log.float()]
        for t in forced:
            cache, log = decode_step(params, cfg, cache, t, rt)
            out.append(log.float())
    return torch.stack(out)


def report(label, a, b, relative=False):
    d = (a - b).abs().amax(dim=(1, 2))
    scale = float(b.abs().max()) if relative else 1.0
    print(json.dumps({"compare": label, "max_dlogit": float(d.max()) / scale,
                      "relative": relative,
                      "by_position": [round(float(x) / scale, 6) for x in d]}),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--depths", default="6,12,24,36")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("logit_sensitivity: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(args.arch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    toks = torch.randint(0, cfg.vocab_size, (2, PROMPT), generator=gen,
                         device=dev)
    forced = torch.randint(0, cfg.vocab_size, (STEPS, 2), generator=gen,
                           device=dev)
    cuda, plain = KernelPolicy.cuda(), KernelPolicy.torch()
    rt = ModelRuntime()
    params = init_params(cfg, seed=0, rt=rt)

    def run(pol, **kw):
        return forced_logits(params, cfg,
                             dataclasses.replace(rt, kernels=pol, **kw),
                             toks, forced)

    base = run(plain)
    report("cuda vs torch", run(cuda), base)
    report("cuda with attention on torch vs torch", run(dataclasses.replace(
        cuda, prefill_attention="torch", decode_attention="torch")), base)
    report("torch, plain flash chunk 256 vs 512",
           run(plain.with_params("prefill_attention", chunk=256)), base)
    for name, pol in (("cuda", cuda), ("torch", plain)):
        report(f"bf16 vs int8 KV, {name} policy", run(pol, kv_dtype="int8"),
               run(pol))
    del params, base
    for depth in (int(x) for x in args.depths.split(",") if x):
        small = dataclasses.replace(cfg, n_layers=depth)
        p = init_params(small, seed=0, rt=rt)
        report(f"cuda vs torch, {depth} layers",
               *(forced_logits(p, small, dataclasses.replace(rt, kernels=pol),
                               toks, forced) for pol in (cuda, plain)))
        del p
    rt32 = ModelRuntime(dtype="float32")
    p32 = init_params(cfg, seed=0, rt=rt32)
    report("cuda vs torch, f32", *(forced_logits(
        p32, cfg, dataclasses.replace(rt32, kernels=pol), toks, forced)
        for pol in (cuda, plain)), relative=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
