"""Fig. 4 reproduction: pipeline (paradigm 1) analytic model vs the
cycle-approximate event simulator (the board stand-in).

Paper: avg 1.15% error between estimated and board-level performance
across AlexNet/ZF/VGG16/YOLO at 16- and 8-bit on ZC706 + KU115.

Workloads come from the registry (CNN front-end of the Workload IR).

The port's copy of ``benchmarks/fig4_pipeline_model_error.py``, on the port's
FPGA models; ``tests/test_torch_figures.py`` holds its rows to the
reference's.
"""
from __future__ import annotations

from repro_torch.core.analytical.pipeline import pipeline_performance
from repro_torch.core.hardware import KU115, ZC706
from repro_torch.core.workload import get_workload
from repro_torch.sim.simulator import simulate_pipeline

from repro_torch.bench.figures.common import emit

# (a) ZC706: N1-N3 = AlexNet/ZF/YOLO @16b, N4-N6 same @8b
# (b) KU115: N1-N4 = AlexNet/ZF/VGG16/YOLO @16b, N5-N8 same @8b
CASES = []
for bits in (16, 8):
    for nm, sz in (("alexnet", 224), ("zf", 224), ("yolo", 448)):
        CASES.append(("ZC706", ZC706, nm, sz, bits))
    for nm, sz in (("alexnet", 224), ("zf", 224), ("vgg16", 224),
                   ("yolo", 448)):
        CASES.append(("KU115", KU115, nm, sz, bits))


def run(batch: int = 2):
    rows = []
    for board, spec, nm, sz, bits in CASES:
        wl = get_workload(nm, input_size=sz, abits=bits, wbits=bits)
        d = pipeline_performance(wl, spec, batch=batch,
                                 wbits=bits, abits=bits)
        if not d.feasible:
            continue
        s = simulate_pipeline(d, spec)
        err = (d.gops() - s.gops) / s.gops * 100
        rows.append({"board": board, "net": nm, "bits": bits,
                     "analytic_gops": d.gops(), "sim_gops": s.gops,
                     "err_pct": err})
    avg = sum(abs(r["err_pct"]) for r in rows) / len(rows)
    rows.append({"board": "AVG", "net": "-", "bits": "-",
                 "analytic_gops": "-", "sim_gops": "-", "err_pct": avg})
    emit("fig4_pipeline_model_error", rows)
    print(f"[fig4] avg |err| = {avg:.2f}%  (paper: 1.15%)")
    return {"avg_err_pct": avg, "paper_err_pct": 1.15,
            "pass": avg <= 3.0}


if __name__ == "__main__":
    run()
