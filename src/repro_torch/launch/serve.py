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

``--scenario NAME`` samples the requests from the traffic scenario
library (``repro_torch.serve.scenarios``, scaled into ``--max-len``) and
runs ``deploy_lint`` against it; ``--preflight`` prints that lint's
bounds and gates the config through the closed-form HBM capacity model
(``repro_torch.analysis.capacity``, the card's 80 GB or ``--hbm-gb``),
refusing an oversized one with ``capacity-hbm-overflow``; ``--strict``
refuses to launch on any error-severity deploy finding (e.g.
``deploy-admission-deadlock``). Both gates price the dtypes of the
runtime that is then built (bf16 on the card, f32 on the CPU), and run
before anything is allocated.

``--mesh DxM`` serves on a (data, model) mesh of D x M ranks, one
process each (``launch.mesh.run_mesh``), through
:class:`~repro_torch.serve.sharded.ShardedServeEngine` (or its paged
twin) under the ``decode`` recipe: weights tensor-parallel over
``model``, slots over ``data``. The weights are drawn once, here, and
each rank copies its blocks of them; on the card the kernel library is
built here and the ranks load it. Rank ``r`` runs on ``cuda:{r %
device_count}``: on one card the ranks share it over ``gloo``, on D x M
cards each has its own over ``nccl`` (``--device cpu``: ``gloo`` on the
CPU). ``--preflight`` and ``--hbm-gb`` then price each device. Rank 0's
run is the one reported, and every rank must have served the same
tokens. The families on a mesh are ``dense`` and ``vlm``; the launcher
refuses the others there.

``main(argv)`` returns what it measured (the requests served, the step
percentiles, the engine's stats and the two gates' reports) to an
in-process caller.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch.analysis.capacity import serve_preflight
from repro_torch.analysis.deploy_lint import DeploymentSpec, deploy_preflight
from repro_torch.configs import get_arch, smoke_config
from repro_torch.dist.sharding import check_mesh_family
from repro_torch.launch.mesh import parse_mesh, run_mesh
from repro_torch.models import ModelRuntime, init_params
from repro_torch.serve import (PagedServeEngine, Request, Sampler,
                               Scheduler, ServeEngine,
                               ShardedPagedServeEngine, ShardedServeEngine,
                               get_scenario)


def _drive(eng, requests, device: str) -> dict:
    """Submit ``requests`` and step ``eng`` until all are served; what
    the report reads, as host data."""
    for r in requests:
        eng.submit(Request(**r))
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    t0 = time.time()
    step_s = []
    while eng.queue or any(s is not None for s in eng.slots):
        t1 = time.time()
        eng.step()
        sync()
        step_s.append(time.time() - t1)
    paged = isinstance(eng, PagedServeEngine)
    return dict(
        seconds=time.time() - t0, step_s=step_s, finished=eng.finished,
        rejected=eng.rejected, stats=eng.stats,
        kv_cache_bytes=eng.kv_cache_bytes(),
        n_pages=eng.n_pages if paged else None,
        live_pages=eng.pages.live_pages if paged else None,
        free_pages=eng.pages.free_pages if paged else None,
        prefix_hit_rate=eng.prefix_hit_rate if paged else None,
        evictions=eng.pages.evictions if paged else None)


def _mesh_rank(mesh, params, cfg, rt, engine_kw, paged: bool, requests,
               device: str) -> dict:
    """One rank of ``--mesh``: the sharded engine over this rank's
    blocks of ``params``, driven as the one-device launcher drives."""
    cls = ShardedPagedServeEngine if paged else ShardedServeEngine
    eng = cls(params, cfg, rt, mesh, **engine_kw)
    run = _drive(eng, requests, device)
    run.update(backend=mesh.backend, rank=mesh.rank,
               tokens={r.rid: list(r.out_tokens) for r in run["finished"]})
    return run


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
    ap.add_argument("--mesh", default=None,
                    help="DxM device mesh, e.g. 2x4 -> (data, model): one "
                         "process a rank, the sharded engines under the "
                         "decode recipe (dense and vlm archs)")
    ap.add_argument("--preflight", action="store_true",
                    help="gate the config through the closed-form HBM "
                         "capacity model before allocating anything; "
                         "reject oversized slots/max-len/page budgets "
                         "(rule capacity-hbm-overflow)")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="per-device HBM budget in GiB for --preflight "
                         "(default: the H100's 80 GB)")
    ap.add_argument("--scenario", default=None,
                    help="named traffic scenario (repro_torch.serve."
                         "scenarios) to sample requests from; with "
                         "--preflight also prints the deploy_lint bounds "
                         "for it (scaled into --max-len if needed)")
    ap.add_argument("--strict", action="store_true",
                    help="refuse to launch on deploy-admission-deadlock "
                         "(and any other error-severity deploy finding)")
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
    # the runtime's compute dtype: both gates price what is then built
    dtype = "bfloat16" if args.device == "cuda" else "float32"
    mesh_shape = sizes = None
    if args.mesh:
        mesh_shape, sizes = parse_mesh(args.mesh)
        try:
            check_mesh_family(cfg, sizes)
        except NotImplementedError as e:
            raise SystemExit(str(e)) from None

    scenario = drep = cap = None
    if args.scenario:
        try:
            scenario = get_scenario(args.scenario).scaled(args.max_len)
        except KeyError as e:
            raise SystemExit(e.args[0]) from None
        dep = DeploymentSpec(
            n_slots=args.slots, max_len=args.max_len, buckets=buckets,
            admit_width=args.admit_width, page_size=args.page_size,
            page_budget=args.page_budget, dtype=dtype, param_dtype=dtype,
            kv_dtypes=(args.kv_dtype,) if args.kv_dtype else (),
            mesh=sizes, hbm_gb=args.hbm_gb)
        drep = deploy_preflight(cfg, scenario, deployment=dep)
        if args.preflight:
            print(f"deploy[{scenario.name}]: rho={drep.rho:.3f} "
                  f"(peak {drep.rho_peak:.3f}) at batch={drep.best_batch}; "
                  f"lower bounds tok p50/p99 {drep.tok_p50_lb_ms:.3f}/"
                  f"{drep.tok_p99_lb_ms:.3f} ms, ttft "
                  f"{drep.ttft_lb_ms:.1f} ms; compiles {drep.compiles} "
                  f"(bound {drep.compile_bound or 'unbounded'}); cache "
                  f"{drep.cache_tokens} tokens")
            for f in drep.findings:
                print(f"  [{f.severity}] {f.rule_id}: {f.message}")
        errors = [f for f in drep.findings if f.severity == "error"]
        if args.strict and errors:
            raise SystemExit(
                f"[{errors[0].rule_id}] scenario {scenario.name!r} is "
                f"statically infeasible on this config: "
                f"{errors[0].message}")

    if args.preflight:
        # pure shape math before any tensor exists: an oversized config
        # costs nothing to reject
        cap = serve_preflight(
            cfg, n_slots=args.slots, max_len=args.max_len,
            page_size=args.page_size or None,
            page_budget=args.page_budget, mesh=sizes, hbm_gb=args.hbm_gb,
            dtype=dtype, param_dtype=dtype, kv_dtype=args.kv_dtype)
        where = f" per device of mesh {sizes}" if sizes else ""
        print(f"preflight: predicted peak "
              f"{cap.peak_bytes / 2**30:.3f} GiB / "
              f"{cap.hbm_bytes / 2**30:.1f} GiB{where} "
              f"(arguments {cap.argument_bytes / 2**30:.3f} GiB: params "
              f"{cap.params_bytes / 2**30:.3f}, cache "
              f"{cap.cache_bytes / 2**30:.3f}; utilization "
              f"{cap.utilization:.2f})")
        if args.device == "cuda":
            total = torch.cuda.get_device_properties(0).total_memory
            print(f"preflight: budget {cap.hbm_bytes} B; the card "
                  f"reports {total} B")
        if not cap.fits:
            raise SystemExit(
                f"[capacity-hbm-overflow] {args.slots} slots x "
                f"{args.max_len} tokens predicts "
                f"{cap.peak_bytes / 2**30:.2f} GiB peak{where}, over the "
                f"{cap.hbm_bytes / 2**30:.1f} GiB budget — shrink "
                f"--slots/--max-len, page the cache or shard wider")

    rt = ModelRuntime(dtype=dtype, attn_chunk=128, device=args.device,
                      kv_dtype=args.kv_dtype, moe_dropless=True)
    # drawn and cast leaf by leaf: the f32 masters never coexist
    params = init_params(cfg, args.seed, device=args.device, rt=rt)
    sched = Scheduler(cfg=cfg, max_len=args.max_len, buckets=buckets,
                      admit_width=args.admit_width)
    sampler = Sampler(kind=args.sampler, temperature=args.temperature,
                      top_k=args.top_k, seed=args.seed)
    kw = dict(n_slots=args.slots, max_len=args.max_len, sampler=sampler,
              scheduler=sched, overflow=args.overflow, eos_id=args.eos)
    paged = args.page_size > 0
    if paged:
        kw.update(page_size=args.page_size, page_budget=args.page_budget,
                  prefix_cache=args.prefix_cache)

    rng = np.random.default_rng(args.seed)
    requests = []
    if scenario is not None:
        # request shapes come from the scenario, so the measured run
        # replays what deploy_preflight bounded
        for i, (_, plen, olen) in enumerate(
                scenario.sample_requests(args.requests, seed=args.seed)):
            prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
            requests.append(dict(rid=i, prompt=prompt, max_new_tokens=olen))
    else:
        for i in range(args.requests):
            plen = int(rng.integers(4, max(5, min(32, args.max_len // 2))))
            prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
            requests.append(dict(rid=i, prompt=prompt,
                                 max_new_tokens=args.max_new))

    backend = None
    if mesh_shape is not None:
        if args.device == "cuda":
            from repro_torch.kernels import _build
            _build.library()           # built once, here; the ranks load it
        runs = run_mesh(_mesh_rank, mesh_shape, params, cfg, rt, kw, paged,
                        requests, args.device, devices=args.device)
        del params
        for r in runs[1:]:
            if r["tokens"] != runs[0]["tokens"]:
                raise RuntimeError(f"rank {r['rank']} served other tokens "
                                   f"than rank 0")
        run, backend = runs[0], runs[0]["backend"]
    else:
        eng = (PagedServeEngine if paged else ServeEngine)(params, cfg, rt,
                                                           **kw)
        del params
        run = _drive(eng, requests, args.device)
    done, dt, step_s = run["finished"], run["seconds"], run["step_s"]

    toks = sum(len(r.out_tokens) for r in done)
    st = run["stats"]
    p50, p99 = (np.percentile(step_s, (50, 99)) * 1e3
                if step_s else (float("nan"),) * 2)
    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu")
    if mesh_shape is not None:
        where += (f", mesh {mesh_shape[0]}x{mesh_shape[1]} (data, model) "
                  f"over {backend}, rank 0 reported")
    print(f"served {len(done)}/{args.requests} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks / dt:.1f} tok/s on {where})")
    print(f"  step latency p50/p99 {p50:.1f}/{p99:.1f} ms; slot "
          f"occupancy {st.occupancy(args.slots):.2f}; prefill compiles "
          f"{st.prefill_compiles} (bound "
          f"{sched.max_prefill_compiles() or 'unbounded'}); "
          f"forced prompt tokens {st.forced_tokens}")
    per = " per device" if mesh_shape is not None else ""
    print(f"  kv cache {run['kv_cache_bytes'] / 2**20:.1f} MiB{per} "
          f"({rt.kv_dtype or rt.dtype}), utilization "
          f"{st.kv_utilization:.2f}, max in-flight {st.max_active}")
    if paged:
        print(f"  paged: {run['n_pages']} pages of {args.page_size} "
              f"tokens, {run['live_pages']} live / {run['free_pages']} "
              f"free; prefix hits {st.prefix_hits} ({st.prefix_hit_tokens} "
              f"tokens, hit rate {run['prefix_hit_rate']:.2f}), evictions "
              f"{run['evictions']}")
    if run["rejected"]:
        print(f"  rejected {len(run['rejected'])}: "
              f"{[(r.rid, r.finish_reason) for r in run['rejected']]}")
    for r in done[:4]:
        print(f"  rid={r.rid} finish={r.finish_reason} "
              f"out={r.out_tokens}")
    return dict(served=len(done), finished=done,
                rejected=len(run["rejected"]), tokens=toks,
                seconds=dt, step_p50_ms=float(p50), step_p99_ms=float(p99),
                stats=st, deploy=drep, preflight=cap,
                compile_bound=sched.max_prefill_compiles(),
                mesh=sizes, backend=backend)


if __name__ == "__main__":
    main()
