"""Fig. 5 reproduction: generic (paradigm 2) analytic model vs the event
simulator over 36 CONV cases — fmap (56,112,224) x channels
(64,128,256,512) x kernel (1,3,5) on VU9P.

Paper: 2.17% average error vs board measurements.

Each case is the registry's ``conv_case`` workload (CNN front-end).

The port's copy of ``benchmarks/fig5_generic_model_error.py``, on the port's
FPGA models; ``tests/test_torch_figures.py`` holds its rows to the
reference's.
"""
from __future__ import annotations

from repro_torch.core.analytical.generic import generic_dse
from repro_torch.core.hardware import VU9P
from repro_torch.core.workload import get_workload
from repro_torch.sim.simulator import simulate_generic

from repro_torch.bench.figures.common import emit


def run():
    rows = []
    for fm in (56, 112, 224):
        for ch in (64, 128, 256, 512):
            for k in (1, 3, 5):
                wl = get_workload("conv_case", fmap=fm, cin=ch, k=k)
                d = generic_dse(wl, VU9P)
                s = simulate_generic(d, VU9P)
                err = (d.gops() - s.gops) / s.gops * 100
                rows.append({"fmap": fm, "ch": ch, "k": k,
                             "analytic_gops": d.gops(),
                             "sim_gops": s.gops, "err_pct": err,
                             "dataflow": d.dataflows[0]})
    avg = sum(abs(r["err_pct"]) for r in rows) / len(rows)
    emit("fig5_generic_model_error", rows)
    print(f"[fig5] 36 cases avg |err| = {avg:.2f}%  (paper: 2.17%)")
    return {"avg_err_pct": avg, "paper_err_pct": 2.17,
            "pass": avg <= 4.0}


if __name__ == "__main__":
    run()
