"""Serve a small model with batched requests: scheduled prefill +
continuous-batching decode, mixed prompt lengths, slot reuse — under a
selectable kernel policy, sampler and KV-cache layout.

    python -m repro_torch.examples.serve_batched [--device cpu]
    python -m repro_torch.examples.serve_batched --use-kernels
    python -m repro_torch.examples.serve_batched --temperature 0.8
    python -m repro_torch.examples.serve_batched --page-size 8

(with ``PYTHONPATH=src``).

The port's counterpart of ``examples/serve_batched.py``: smoke
``starcoder2-3b`` in f32, 4 slots, ten requests. ``--use-kernels``
routes every hot spot (prefill attention, split-KV decode attention —
paged or contiguous — and the norms) through the ``cuda`` kernel
policy, the hand-written kernels on the card (their plain versions on
the CPU); without it the ``torch`` policy runs. Greedy tokens are
identical under both policies — the live demonstration of the kernel
dispatch seam. ``--temperature`` switches the (per-request seeded,
reproducible) sampler off greedy. ``--page-size`` swaps the per-slot
contiguous cache for the paged engine (pooled KV pages + page tables +
prompt-prefix sharing); tokens are again identical. ``--kv-dtype int8``
stores the KV cache quantized (per-row symmetric, bf16 scale
side-bands) — with ``--page-size`` the same byte budget re-denominates
into ~2x pages. The scheduler buckets the ten distinct prompt lengths
onto a handful of prefill shapes — watch the shape count. ``--device``
defaults to ``cuda``.

``main(argv)`` returns each request's tokens and the engine's stats.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.examples.serve_batched")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default) needs a card; cpu runs the "
                         "kernels' plain versions")
    ap.add_argument("--use-kernels", action="store_true",
                    help="serve through the cuda kernel policy (the "
                         "hand-written kernels on the card)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="> 0 switches greedy decoding to seeded "
                         "temperature sampling")
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV page size in tokens; > 0 serves through the "
                         "paged engine (pooled pages, not per-slot caches)")
    ap.add_argument("--page-budget", type=int, default=None,
                    help="pool size in pages incl. the null page (default: "
                         "the fixed engine's equivalent KV bytes)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="share prompt-prefix pages across requests "
                         "(paged engine only)")
    ap.add_argument("--kv-dtype", choices=("bfloat16", "int8"), default=None,
                    help="KV-cache storage precision (default: the compute "
                         "dtype); 'int8' quantizes rows at write time")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.models import ModelRuntime, init_params
    from repro_torch.serve import (PagedServeEngine, Request, Sampler,
                                   ServeEngine)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device available: pass --device cpu")
    cfg = smoke_config(ARCHS["starcoder2-3b"])
    policy = KernelPolicy.cuda() if args.use_kernels else KernelPolicy.torch()
    rt = ModelRuntime(dtype="float32", remat="none", attn_chunk=64,
                      kernels=policy, kv_dtype=args.kv_dtype,
                      device=args.device)
    print(f"kernel policy: {rt.kernel_policy().describe()}")
    sampler = (Sampler(kind="temperature", temperature=args.temperature,
                       top_k=32, seed=0)
               if args.temperature > 0 else Sampler())
    params = init_params(cfg, seed=0, device=args.device)
    if args.page_size > 0:
        eng = PagedServeEngine(params, cfg, rt, n_slots=4, max_len=128,
                               sampler=sampler, page_size=args.page_size,
                               page_budget=args.page_budget,
                               prefix_cache=args.prefix_cache)
    else:
        eng = ServeEngine(params, cfg, rt, n_slots=4, max_len=128,
                          sampler=sampler)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for i in range(10):
        plen = int(rng.integers(4, 48))
        eng.submit(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, plen,
                                       dtype=np.int32),
            max_new_tokens=int(rng.integers(4, 12))))
    done = eng.run()
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    st = eng.stats
    print(f"served {len(done)} requests / {toks} tokens in {dt:.1f}s "
          f"with 4 slots (continuous batching); "
          f"{st.prefill_compiles} prefill shapes for 10 prompt lengths "
          f"(bound {eng.scheduler.max_prefill_compiles()}), "
          f"occupancy {st.occupancy(4):.2f}, "
          f"kv utilization {st.kv_utilization:.2f}")
    if args.page_size > 0:
        print(f"paged: pool={eng.pages.n_pages} pages x {args.page_size} "
              f"tokens, prefix hits={st.prefix_hits} "
              f"(hit tokens {st.prefix_hit_tokens})")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  rid={r.rid:2d} prompt_len={len(r.prompt):2d} "
              f"finish={r.finish_reason} -> {r.out_tokens}")
    return dict(tokens={r.rid: list(r.out_tokens) for r in done}, stats=st)


if __name__ == "__main__":
    main()
