"""Fig. 11 reproduction: two-level DSE exploration traces for
ResNet-18/-34 and AlexNet on KU115 and ZC706 (batch unrestricted),
through the shared ``DesignSpace`` + cached search core.

Paper: converges within the first ~10 of 20 iterations; best
throughputs 1642.6 / 1640.6 / 1501.2 GOP/s (KU115) and 258.9 / 236.1 /
201.6 GOP/s (ZC706).

On top of the paper's scalar trace this reports what the refactored
core adds: memo-cache savings (unique analytical evaluations strictly
below the n_particles*(n_iters+1) PSO budget) and the size of the
(throughput, latency, efficiency) Pareto frontier each search exposes.

The port's copy of ``benchmarks/fig11_dse_convergence.py``, on the port's
FPGA models; ``tests/test_torch_figures.py`` holds its rows to the
reference's.
"""
from __future__ import annotations

from repro_torch.core.dse import explore_fpga
from repro_torch.core.hardware import KU115, ZC706
from repro_torch.core.workload import get_workload

from repro_torch.bench.figures.common import emit

PAPER = {
    ("resnet18", "KU115"): 1642.6, ("resnet34", "KU115"): 1640.6,
    ("alexnet", "KU115"): 1501.2, ("resnet18", "ZC706"): 258.9,
    ("resnet34", "ZC706"): 236.1, ("alexnet", "ZC706"): 201.6,
}


def run(n_particles: int = 16, n_iters: int = 20):
    rows = []
    for nm in ("resnet18", "resnet34", "alexnet"):
        wl = get_workload(nm, input_size=224)
        for spec in (KU115, ZC706):
            res = explore_fpga(wl, spec, n_particles=n_particles,
                               n_iters=n_iters, max_batch=64)
            s = res.search
            hist = res.gops_trace
            target = 0.99 * hist[-1]
            conv_iter = next(i for i, v in enumerate(hist) if v >= target)
            got = res.best_design.gops()
            exp = PAPER[(nm, spec.name)]
            rows.append({
                "net": nm, "board": spec.name, "gops": got,
                "paper_gops": exp, "ratio": got / exp,
                "batch": res.best_design.batch, "sp": res.best_design.sp,
                "converged_iter": conv_iter,
                "unique_evals": s.unique_evaluations,
                "eval_budget": n_particles * (n_iters + 1),
                "cache_hits": s.cache_hits,
                "pareto_size": len(s.pareto),
                "trace": [round(v, 1) for v in hist],
            })
    emit("fig11_dse_convergence", rows,
         keys=["net", "board", "gops", "paper_gops", "ratio", "batch",
               "sp", "converged_iter", "unique_evals", "cache_hits",
               "pareto_size"])
    conv_ok = all(r["converged_iter"] <= 10 for r in rows)
    within = [r for r in rows if 0.75 <= r["ratio"] <= 1.35]
    budget = n_particles * (n_iters + 1)
    cache_ok = all(r["unique_evals"] < budget for r in rows)
    pareto_ok = all(r["pareto_size"] >= 1 for r in rows)
    saved = sum(budget - r["unique_evals"] for r in rows)
    print(f"[fig11] all converge <=10 iters: {conv_ok}; "
          f"{len(within)}/6 within 0.75-1.35x of paper GOP/s; "
          f"cache saved {saved} analytical evals over 6 searches "
          f"(all < budget {budget}: {cache_ok}); "
          f"pareto non-empty everywhere: {pareto_ok}")
    return {"converged_le_10": conv_ok, "within_band": len(within),
            "cache_below_budget": cache_ok, "evals_saved": saved,
            "pareto_nonempty": pareto_ok,
            "pass": (conv_ok and len(within) >= 5 and cache_ok
                     and pareto_ok)}


if __name__ == "__main__":
    run()
