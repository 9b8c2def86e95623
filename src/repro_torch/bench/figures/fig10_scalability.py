"""Fig. 10 reproduction: throughput of the three paradigms on deeper
VGG-like DNNs (13/18/28/38 CONV layers, 3x224x224 inputs, KU115).

Paper claims: paradigm 1 drops 77.8% from 13 to 38 layers; paradigms
2 and 3 hold peak; paradigm 3 up to 4.2x paradigm 1 at 38 layers.

The port's copy of ``benchmarks/fig10_scalability.py``, on the port's
FPGA models; ``tests/test_torch_figures.py`` holds its rows to the
reference's.
"""
from __future__ import annotations

from repro_torch.core.dse.engine import benchmark_paradigm
from repro_torch.core.hardware import KU115
from repro_torch.core.workload import get_workload

from repro_torch.bench.figures.common import emit

DEPTHS = {13: 0, 18: 1, 28: 3, 38: 5}   # extra CONV per group


def run():
    rows = []
    gops = {p: {} for p in (1, 2, 3)}
    for depth, extra in DEPTHS.items():
        wl = get_workload("vgg16", input_size=224, extra_per_group=extra)
        row = {"layers": depth}
        for p in (1, 2, 3):
            r = benchmark_paradigm(wl, KU115, p, batch=1)
            gops[p][depth] = r.gops
            row[f"p{p}_gops"] = r.gops
        rows.append(row)
    for row in rows:
        d = row["layers"]
        for p in (1, 2, 3):
            row[f"p{p}_norm"] = gops[p][d] / max(gops[p][13], 1e-9)
    emit("fig10_scalability", rows)
    p1_drop = 1.0 - gops[1][38] / gops[1][13]
    ratio = gops[3][38] / max(gops[1][38], 1e-9)
    print(f"[fig10] paradigm-1 drop 13->38L: {p1_drop*100:.1f}% "
          f"(paper 77.8%); p3/p1 @38L: {ratio:.2f}x (paper 4.2x)")
    return {"p1_drop_pct": p1_drop * 100, "p3_over_p1_38L": ratio,
            "paper_drop_pct": 77.8, "paper_ratio": 4.2,
            "pass": p1_drop >= 0.5 and ratio >= 3.0}


if __name__ == "__main__":
    run()
