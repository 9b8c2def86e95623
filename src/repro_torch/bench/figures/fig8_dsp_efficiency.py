"""Fig. 8 reproduction: DSP efficiency of the three paradigms running
VGG16 (batch=1, 16-bit) at 12 input sizes on KU115.

Paper claims: paradigm 1 highest (dedicated stages); paradigm 3 slightly
behind for small inputs, >95% efficiency from case 3 on; paradigm 3 is
2.0x / 1.3x the generic design's efficiency at cases 1 / 2.

The port's copy of ``benchmarks/fig8_dsp_efficiency.py``, on the port's
FPGA models; ``tests/test_torch_figures.py`` holds its rows to the
reference's.
"""
from __future__ import annotations

from repro_torch.core.dse.engine import benchmark_paradigm
from repro_torch.core.hardware import KU115
from repro_torch.core.workload import INPUT_SIZE_CASES, get_workload

from repro_torch.bench.figures.common import emit


def run(n_cases: int = 12):
    rows = []
    for i, sz in enumerate(INPUT_SIZE_CASES[:n_cases]):
        wl = get_workload("vgg16", input_size=sz)
        effs = {}
        for p in (1, 2, 3):
            r = benchmark_paradigm(wl, KU115, p, batch=1, seed=i)
            effs[p] = r.efficiency          # DSP efficiency
        rows.append({"case": i + 1, "input": sz,
                     "p1_eff": effs[1], "p2_eff": effs[2],
                     "p3_eff": effs[3],
                     "p3_over_p2": effs[3] / max(effs[2], 1e-9)})
    emit("fig8_dsp_efficiency", rows)
    r1, r2 = rows[0]["p3_over_p2"], rows[1]["p3_over_p2"]
    tail_ok = all(r["p3_eff"] > 0.95 for r in rows[2:])
    print(f"[fig8] p3/p2 efficiency: case1 {r1:.2f}x (paper 2.0x), "
          f"case2 {r2:.2f}x (paper 1.3x); p3>95% after case3: {tail_ok}")
    return {"case1_ratio": r1, "case2_ratio": r2, "tail_over_95": tail_ok,
            "pass": r1 >= 1.5 and r2 >= 1.1}


if __name__ == "__main__":
    run()
