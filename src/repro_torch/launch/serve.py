"""Serving launcher of the port:
``python -m repro_torch.launch.serve --arch minicpm-2b [--smoke] [--device cpu]``

``--arch`` takes every arch of the registry: the dense ``minicpm-2b``,
``chatglm3-6b`` (2d RoPE), ``starcoder2-3b`` (LayerNorm, GELU MLP) and
``stablelm-12b`` (LayerNorm, qk-norm, head dim 160), the VLM backbone
``qwen2-vl-7b`` (M-RoPE; served on text tokens), ``qwen2-moe-a2.7b`` and
``mixtral-8x22b`` (MoE, served dropless as the reference launcher does),
``mamba2-1.3b`` (pure SSM) and ``zamba2-2.7b`` (hybrid; both admitted in
chunk mode). The encoder-only ``hubert-xlarge`` has no decode step and
exits, as the reference launcher does. Full-width ``mixtral-8x22b``
(~282 GB in bf16) does not fit one card; its ``--smoke`` config runs
anywhere.

Scheduled continuous batching: bucketed/chunked prefill, seeded
sampling (greedy / temperature / top-k) and cache-budget admission, over
the contiguous cache of :class:`~repro_torch.serve.engine.ServeEngine`
or, with ``--page-size N``, the page pool of
:class:`~repro_torch.serve.paged.PagedServeEngine` (``--page-budget``,
``--prefix-cache``). ``--kv-dtype int8`` quantizes the KV cache under
either engine. Runs on the CUDA card (bf16, the hand-written kernels)
unless ``--device cpu`` is given (f32, the kernels' plain versions, as
the reference launcher's f32 runtime). Prints tok/s, per-step latency
percentiles, slot occupancy, the prefill shape count, the KV cache and
any rejected requests, as the reference launcher does.

Meshes, the preflight and scenarios come with their slices (ROADMAP.md
Queue 1 item 13).
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_config
from repro_torch.models import ModelRuntime, init_params
from repro_torch.serve import (PagedServeEngine, Request, Sampler,
                               Scheduler, ServeEngine)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default) needs a card; cpu runs the "
                         "kernels' plain versions")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--buckets", default=None,
                    help="comma-separated prefill bucket lengths "
                         "(default: powers of two up to max-len; "
                         "'exact' disables bucketing)")
    ap.add_argument("--admit-width", type=int, default=1,
                    help="fixed batch width of every prefill call")
    ap.add_argument("--sampler", choices=("greedy", "temperature"),
                    default="greedy")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--eos", type=int, default=None,
                    help="token id terminating a request early")
    ap.add_argument("--overflow", choices=("reject", "truncate", "error"),
                    default="reject",
                    help="policy for prompt+max-new > max-len requests")
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV page size in tokens; > 0 selects the paged "
                         "engine (pooled pages + page tables instead of "
                         "per-slot contiguous caches)")
    ap.add_argument("--page-budget", type=int, default=None,
                    help="total pages in the pool incl. the null page "
                         "(default: the contiguous engine's KV bytes)")
    ap.add_argument("--kv-dtype", choices=("bfloat16", "int8"),
                    default=None,
                    help="KV-cache storage precision (default: the "
                         "runtime compute dtype). 'int8' quantizes "
                         "per-(token, head) with bf16 scale side-bands; "
                         "the paged engine re-denominates the same byte "
                         "budget into ~2x pages")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="share prompt-prefix pages across requests "
                         "(paged engine only)")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device available: repro_torch serves on "
                         "the card; pass --device cpu to run on the CPU")
    logging.basicConfig(level=logging.INFO)
    try:
        cfg = get_arch(args.arch)
    except KeyError as e:
        raise SystemExit(str(e)) from None
    if args.smoke:
        cfg = smoke_config(cfg)
    if cfg.is_encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")

    if args.buckets == "exact":
        buckets = ()
    elif args.buckets:
        buckets = tuple(int(b) for b in args.buckets.split(","))
    else:
        buckets = None

    rt = ModelRuntime(dtype="bfloat16" if args.device == "cuda"
                      else "float32", attn_chunk=128, device=args.device,
                      kv_dtype=args.kv_dtype, moe_dropless=True)
    # drawn and cast leaf by leaf: the f32 masters never coexist
    params = init_params(cfg, args.seed, device=args.device, rt=rt)
    sched = Scheduler(cfg=cfg, max_len=args.max_len, buckets=buckets,
                      admit_width=args.admit_width)
    sampler = Sampler(kind=args.sampler, temperature=args.temperature,
                      top_k=args.top_k, seed=args.seed)
    kw = dict(n_slots=args.slots, max_len=args.max_len, sampler=sampler,
              scheduler=sched, overflow=args.overflow, eos_id=args.eos)
    if args.page_size > 0:
        eng = PagedServeEngine(params, cfg, rt, page_size=args.page_size,
                               page_budget=args.page_budget,
                               prefix_cache=args.prefix_cache, **kw)
    else:
        eng = ServeEngine(params, cfg, rt, **kw)
    del params

    rng = np.random.default_rng(args.seed)
    for i in range(args.requests):
        plen = int(rng.integers(4, max(5, min(32, args.max_len // 2))))
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        eng.submit(Request(rid=i, prompt=prompt,
                           max_new_tokens=args.max_new))

    sync = torch.cuda.synchronize if args.device == "cuda" else (lambda: None)
    t0 = time.time()
    step_s = []
    while eng.queue or any(s is not None for s in eng.slots):
        t1 = time.time()
        eng.step()
        sync()
        step_s.append(time.time() - t1)
    dt = time.time() - t0
    done = eng.finished

    toks = sum(len(r.out_tokens) for r in done)
    st = eng.stats
    p50, p99 = (np.percentile(step_s, (50, 99)) * 1e3
                if step_s else (float("nan"),) * 2)
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu")
    print(f"served {len(done)}/{args.requests} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks / dt:.1f} tok/s on {where})")
    print(f"  step latency p50/p99 {p50:.1f}/{p99:.1f} ms; slot "
          f"occupancy {st.occupancy(args.slots):.2f}; prefill compiles "
          f"{st.prefill_compiles} (bound "
          f"{sched.max_prefill_compiles() or 'unbounded'}); "
          f"forced prompt tokens {st.forced_tokens}")
    print(f"  kv cache {eng.kv_cache_bytes() / 2**20:.1f} MiB "
          f"({rt.kv_dtype or rt.dtype}), utilization "
          f"{st.kv_utilization:.2f}, max in-flight {st.max_active}")
    if args.page_size > 0:
        print(f"  paged: {eng.n_pages} pages of {args.page_size} tokens, "
              f"{eng.pages.live_pages} live / {eng.pages.free_pages} free; "
              f"prefix hits {st.prefix_hits} ({st.prefix_hit_tokens} "
              f"tokens, hit rate {eng.prefix_hit_rate:.2f}), evictions "
              f"{eng.pages.evictions}")
    if eng.rejected:
        print(f"  rejected {len(eng.rejected)}: "
              f"{[(r.rid, r.finish_reason) for r in eng.rejected]}")
    for r in done[:4]:
        print(f"  rid={r.rid} finish={r.finish_reason} "
              f"out={r.out_tokens}")


if __name__ == "__main__":
    main()
