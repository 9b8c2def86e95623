"""Quickstart: the paper's flow in the port, in about a minute.

1. pull a workload from the registry (the Workload IR every subsystem
   consumes) and benchmark the two established accelerator paradigms,
2. explore the paper's hybrid paradigm with the two-level DSE,
3. the same technique on one H100: profile chatglm3-6b at ``train_4k``
   (the arch the reference's step 3 explores on a pod), run the
   one-card DSE (``explore_gpu``) over its plans, print the predicted
   roofline, and run the search again on the port's own model traced
   into the IR (``trace:chatglm3-6b/train_4k``),
4. close the analytic<->measured loop: microbenchmark the kernel
   dispatch ops (the tuner's ``ci`` preset on ``--device``) and evaluate
   a workload from the measured timings.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port's counterpart of ``examples/quickstart.py``. ``--device``
defaults to ``cuda``; ``cpu`` times the plain versions.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda",
                    help="where step 4 times the kernels (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch, get_shape
    from repro_torch.core.analytical import DesignPoint, MeasuredModel
    from repro_torch.core.dse import (benchmark_paradigm, explore_fpga,
                                      explore_gpu)
    from repro_torch.core.hardware import KU115
    from repro_torch.core.workload import get_workload, lm_workload
    from repro_torch.kernels.tune import TUNE_PRESETS, run_tuning

    print("== step 1-2: FPGA-domain benchmarking (the paper's own flow) ==")
    wl = get_workload("resnet18", input_size=224)
    print(f"workload: {wl.describe()}")
    for p in (1, 2):
        r = benchmark_paradigm(wl, KU115, p, batch=1)
        print(f"paradigm {p}: {r.gops:7.1f} GOP/s, DSP efficiency "
              f"{r.efficiency:.2f}")

    res = explore_fpga(wl, KU115, n_particles=12, n_iters=12)
    d = res.best_design
    conv = next(i for i, v in enumerate(res.gops_trace)
                if v >= 0.99 * res.gops_trace[-1])
    print(f"paradigm 3 (two-level DSE): {d.gops():7.1f} GOP/s "
          f"(SP={d.sp}, batch={d.batch}) — converged in {conv} iterations")

    print("\n== step 3: the same technique on one H100 ==")
    cfg = get_arch("chatglm3-6b")
    shape = get_shape("train_4k")
    lm = get_workload("chatglm3-6b/train_4k")
    print(f"workload: {lm.describe()}")
    for label, workload in (("analytic", None),
                            ("traced", get_workload(
                                "trace:chatglm3-6b/train_4k"))):
        t = explore_gpu(cfg, shape, n_particles=10, n_iters=10,
                        workload=workload)
        a = t.best_analysis
        quant = t.search.best_point["quant"] >= 0.5
        print(f"{cfg.name} x {shape.name} ({label} profile): best plan "
              f"M={t.best_plan.microbatches} "
              f"{'int8' if quant else 'bf16'} remat={t.best_plan.remat}")
        print(f"  predicted terms: compute {a.compute_s:.2f}s, memory "
              f"{a.memory_s:.2f}s -> bottleneck: {a.dominant}; roofline "
              f"fraction {t.best_fitness:.3f}")

    print(f"\n== step 4: measured kernels close the loop "
          f"(device {args.device}) ==")
    pset = TUNE_PRESETS["ci"]
    calib = run_tuning(pset, cells=[("minicpm-2b", "prefill_32k")], reps=1,
                       device=args.device)
    wl_smoke = lm_workload(pset.arch("minicpm-2b"),
                           pset.shape("prefill_32k"))
    m = MeasuredModel(wl_smoke, calib).evaluate(DesignPoint.make())
    src = m.resources
    print(f"{wl_smoke.name} from measured kernel timings: "
          f"{m.latency_s * 1e3:.2f} ms/step ({m.gops:.1f} GOP/s; "
          f"{src['measured_ops']:.0f} ops measured, "
          f"{src['interpolated_ops']:.0f} roofline-interpolated)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
