"""Figure driver: ``python -m repro_torch.bench.figures [--quick]``.

The port's counterpart of the reference's ``benchmarks/run.py`` for its
seven paper figures. ``--list`` prints the figure names; every run
writes ``<artifacts>/bench/results.json`` (per-figure metrics + wall
seconds, the reference runner's schema) under
``repro_torch.artifacts.bench_dir()`` (``$REPRO_TORCH_ARTIFACT_DIR``).
Exits 0 only if every selected figure reports ``pass: True``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time


def build_benches(quick: bool = False) -> list:
    """The single source of truth: (name, module, entry, args, kwargs),
    with the reference runner's arguments. Modules are imported lazily
    at execution time, so ``--list`` stays cheap."""
    n_cases = 6 if quick else 12
    fig11_kw = {"n_particles": 12, "n_iters": 12} if quick else {}
    return [
        ("fig4", "fig4_pipeline_model_error", "run", (), {}),
        ("fig5", "fig5_generic_model_error", "run", (), {}),
        ("fig6", "fig6_ctc", "run", (), {}),
        ("fig8", "fig8_dsp_efficiency", "run", (n_cases,), {}),
        ("fig9", "fig9_resource_split", "run", (n_cases,), {}),
        ("fig10", "fig10_scalability", "run", (), {}),
        ("fig11", "fig11_dse_convergence", "run", (), fig11_kw),
    ]


def benchmark_names() -> list:
    return [b[0] for b in build_benches()]


def write_results(results: dict, quick: bool = False,
                  only: str = None) -> str:
    """Persist the per-figure metric dicts + timings as JSON, with the
    run mode (quick/only + the full roster)."""
    from repro_torch.artifacts import bench_dir

    os.makedirs(bench_dir(), exist_ok=True)
    path = os.path.join(bench_dir(), "results.json")
    results = {k: {**r, "pass": bool(r.get("pass"))}
               for k, r in results.items()}
    payload = {
        "generated_unix": time.time(),
        "quick": bool(quick),
        "only": sorted(only.split(",")) if only else None,
        "available": benchmark_names(),
        "ran": sorted(results),
        "benchmarks": results,
        "pass": all(r["pass"] for r in results.values()),
    }

    def _default(o):                    # numpy scalars -> plain numbers
        return o.item() if hasattr(o, "item") else str(o)

    with open(path, "w") as f:
        json.dump(payload, f, indent=1, default=_default)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.bench.figures")
    ap.add_argument("--quick", action="store_true",
                    help="fewer DSE cases for fig8/9, smaller fig11 swarm")
    ap.add_argument("--only", default=None,
                    help="comma-separated figure names")
    ap.add_argument("--list", action="store_true",
                    help="print the figure names and exit")
    args = ap.parse_args(argv)

    if args.list:
        for n in benchmark_names():
            print(n)
        return 0

    benches = build_benches(args.quick)
    if args.only:
        names = set(args.only.split(","))
        unknown = names - {b[0] for b in benches}
        if unknown:
            print(f"unknown figure(s): {sorted(unknown)}; available: "
                  f"{benchmark_names()}", file=sys.stderr)
            return 2
        benches = [b for b in benches if b[0] in names]

    results = {}
    t_all = time.time()
    for name, mod, entry, b_args, b_kwargs in benches:
        t0 = time.time()
        try:
            fn = getattr(importlib.import_module(
                f"repro_torch.bench.figures.{mod}"), entry)
            results[name] = fn(*b_args, **b_kwargs)
            results[name]["seconds"] = round(time.time() - t0, 1)
        except Exception as e:                        # noqa: BLE001
            results[name] = {"pass": False,
                             "seconds": round(time.time() - t0, 1),
                             "error": f"{type(e).__name__}: {e}"}
            import traceback
            traceback.print_exc()

    path = write_results(results, quick=args.quick, only=args.only)
    print("\n==== SUMMARY ====")
    ok = True
    for name, r in results.items():
        status = "PASS" if r.get("pass") else "FAIL"
        ok &= bool(r.get("pass"))
        extra = {k: v for k, v in r.items()
                 if k not in ("pass",) and not isinstance(v, (list, dict))}
        print(f"{status:4s} {name:18s} {extra}")
    print(f"total {time.time() - t_all:.0f}s -> {path}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
