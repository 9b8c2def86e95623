"""Accelerator exploration deep-dive (the paper's §6 experiments, live).

Reproduces the scalability experiment (Fig. 10) and one DSE trace
(Fig. 11) interactively, then runs the one-card DSE across three of the
port's architecture families, each on its analytic profile and on the
port's model traced into the IR. Both explorers drive the same
``AcceleratorModel`` + ``DesignSpace`` search core, so the FPGA and card
sections differ only in which model/space they hand it. Each search
also prints its memo-cache savings and the Pareto frontier.

    PYTHONPATH=src python -m repro_torch.examples.explore_accelerator

The port's counterpart of ``examples/explore_accelerator.py``: the card
section explores the archs its pod section does (stablelm-12b,
mixtral-8x22b, mamba2-1.3b). Nothing here runs on a device: the traces
are abstract (``meta``).
"""
from __future__ import annotations

import sys


def main() -> int:
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.core.dse import (benchmark_paradigm, explore_fpga,
                                      explore_gpu)
    from repro_torch.core.hardware import KU115
    from repro_torch.core.workload import get_workload, trace_workload

    print("== Fig. 10: deeper DNNs (13 -> 38 CONV layers) ==")
    for extra, depth in ((0, 13), (1, 18), (3, 28), (5, 38)):
        wl = get_workload("vgg16", input_size=224, extra_per_group=extra)
        row = [f"{depth}L"]
        for p in (1, 2, 3):
            r = benchmark_paradigm(wl, KU115, p, batch=1)
            row.append(f"p{p}={r.gops:7.1f}")
        print("  " + "  ".join(row))

    print("\n== Fig. 11-style DSE trace (VGG16 / KU115) ==")
    res = explore_fpga(get_workload("vgg16"), KU115, n_particles=16,
                       n_iters=12)
    for i, (g, sp, b) in enumerate(zip(res.gops_trace, res.sp_trace,
                                       res.batch_trace)):
        print(f"  iter {i:2d}: best {g:7.1f} GOP/s  (SP={sp}, batch={b})")
    s = res.search
    print(f"  cache: {s.unique_evaluations} unique analytical evals for "
          f"{s.calls} fitness calls ({s.cache_hits} hits)")
    print("  pareto frontier (throughput imgs/s, latency s, dsp-eff):")
    for e in sorted(res.pareto, key=lambda e: -e.result.throughput)[:5]:
        r = e.result
        print(f"    SP={int(e.point['sp']):2d} "
              f"batch={int(e.point['batch']):2d}"
              f"  thr={r.throughput:9.1f}  lat={r.latency_s * 1e3:7.2f} ms"
              f"  eff={r.efficiency:.3f}")

    print("\n== one-card DSE across architecture families (H100) ==")
    shape = get_shape("train_4k")
    for arch in ("stablelm-12b", "mixtral-8x22b", "mamba2-1.3b"):
        cfg = get_arch(arch)
        for label, workload in (("analytic", None),
                                ("traced", trace_workload(cfg, shape))):
            t = explore_gpu(cfg, shape, n_particles=10, n_iters=10,
                            workload=workload)
            a = t.best_analysis
            s = t.search
            verdict = (f"roofline~{t.best_fitness:.3f}" if t.best_fitness
                       else f"infeasible ({s.best_result.reason})")
            print(f"  {arch:16s} {label:8s}: M={t.best_plan.microbatches:2d}"
                  f" dom={a.dominant:9s} {verdict} "
                  f"(cache {s.cache_hits}/{s.calls} hits, "
                  f"pareto {len(t.pareto)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
