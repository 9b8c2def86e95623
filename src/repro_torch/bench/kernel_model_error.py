"""Roofline prediction against the port's kernel measurements, per op,
and whole workloads priced by the measured model.

    PYTHONPATH=src python -m repro_torch.bench.kernel_model_error \\
        [--calibration PATH]

The port's counterpart of ``benchmarks/kernel_model_error.py`` (the
kernel-granularity analogue of the paper's Figs. 4/5 model error). The
measurement is a calibration written by ``repro_torch.kernels.tune``;
the analytic side is the roofline every analytical model of the repo
uses, ``pred(op) = max(flops / F_hat, bytes / B_hat)``, with (F_hat,
B_hat) the best FLOP/s and byte/s any measured entry reached (a one-time
calibration from the table itself). Ops the roofline explains sit near
0 %; launch overhead and badly tiled kernels stand out.

The second section evaluates each calibrated cell's whole workload with
:class:`MeasuredModel` against the H100's peak, counting the ops it
measured and the ops it interpolated. Both tables are written as JSON
under the port's artifact root (``<root>/bench/``).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import Any, Dict, List, Optional, Tuple, Union

from repro_torch.artifacts import bench_dir
from repro_torch.core.analytical.interface import DesignPoint
from repro_torch.core.analytical.measured import (MeasuredModel,
                                                  load_calibration)
from repro_torch.core.hardware import H100_SXM, GPUSpec
from repro_torch.core.workload import lm_workload


def fit_envelope(entries) -> Tuple[float, float]:
    """The best achieved FLOP/s and byte/s any measured entry reached
    (the roofline the predictions use)."""
    F = max((e["flops"] / e["best_s"] for e in entries
             if e["flops"] > 0 and e["best_s"] > 0), default=float("inf"))
    B = max((e["bytes"] / e["best_s"] for e in entries
             if e["bytes"] > 0 and e["best_s"] > 0), default=float("inf"))
    return F, B


def op_rows(calib: Dict[str, Any]) -> List[Dict[str, Any]]:
    """One row per measured entry: its time, the roofline's, the error."""
    entries = [e for e in calib["entries"] if e["best_s"] > 0]
    F_hat, B_hat = fit_envelope(entries)
    rows = []
    for e in entries:
        pred = max(e["flops"] / F_hat if e["flops"] else 0.0,
                   e["bytes"] / B_hat if e["bytes"] else 0.0)
        meas = e["best_s"]
        rows.append({
            "op": e["op"], "arch": e["arch"], "shape": e["shape"],
            "winner": e["winner"], "measured_ms": meas * 1e3,
            "roofline_ms": pred * 1e3,
            "err_pct": abs(pred - meas) / meas * 100.0,
        })
    return rows


def workload_rows(calib: Dict[str, Any],
                  chip: GPUSpec = H100_SXM) -> List[Dict[str, Any]]:
    """Each calibrated cell's whole workload, at the preset's scale,
    priced by :class:`MeasuredModel` from the same table."""
    from repro_torch.kernels.tune import TUNE_PRESETS
    pset = TUNE_PRESETS[calib["preset"]]
    rows = []
    for arch, shape in calib["cells"]:
        wl = lm_workload(pset.arch(arch), pset.shape(shape))
        r = MeasuredModel(wl, calib, chip=chip).evaluate(DesignPoint.make())
        rows.append({
            "workload": wl.name, "latency_ms": r.latency_s * 1e3,
            "gops": r.gops, "efficiency": r.efficiency,
            "measured_ops": int(r.resources["measured_ops"]),
            "interpolated_ops": int(r.resources["interpolated_ops"]),
            "feasible": r.feasible,
        })
    return rows


def run(calibration: Union[None, str, Dict[str, Any]] = None,
        chip: GPUSpec = H100_SXM) -> Dict[str, Any]:
    """Both tables from a calibration (a payload, a path, or the port's
    default path); writes them under ``bench_dir()`` and returns the
    summary with the rows."""
    calib = (calibration if isinstance(calibration, dict)
             else load_calibration(calibration))
    rows = op_rows(calib)
    errs = [r["err_pct"] for r in rows]
    wl_rows = workload_rows(calib, chip)
    summary = {
        "preset": calib["preset"], "backend": calib["backend"],
        "device": calib.get("device"), "chip": chip.name,
        "ops": len(rows),
        "median_err_pct": statistics.median(errs) if errs else float("nan"),
        "mean_err_pct": statistics.fmean(errs) if errs else float("nan"),
        "workloads": len(wl_rows),
        "pass": (len(rows) > 0 and all(r["feasible"] for r in wl_rows)
                 and all(e == e and e != float("inf") for e in errs)),
    }
    os.makedirs(bench_dir(), exist_ok=True)
    for name, data in (("kernel_model_error", rows),
                       ("kernel_measured_workloads", wl_rows),
                       ("kernel_model_error_summary", summary)):
        with open(os.path.join(bench_dir(), name + ".json"), "w") as f:
            json.dump(data, f, indent=1)
    return dict(summary, op_rows=rows, workload_rows=wl_rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.bench.kernel_model_error",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--calibration", default=None,
                    help="calibration path (default: the port's)")
    args = ap.parse_args(argv)
    out = run(args.calibration)
    for r in out["op_rows"]:
        print(f"{r['arch']}/{r['shape']} {r['op']}: measured "
              f"{r['measured_ms']:.4f} ms ({r['winner']}), roofline "
              f"{r['roofline_ms']:.4f} ms, error {r['err_pct']:.1f} %")
    for r in out["workload_rows"]:
        print(f"{r['workload']}: {r['latency_ms']:.3f} ms, {r['gops']:.1f} "
              f"GOP/s, efficiency {r['efficiency']:.4f}, ops measured "
              f"{r['measured_ops']} / interpolated {r['interpolated_ops']}")
    print(f"[kernel-model/{out['preset']}] {out['ops']} measured ops; "
          f"roofline-vs-measured error median {out['median_err_pct']:.1f} % "
          f"/ mean {out['mean_err_pct']:.1f} % (backend {out['backend']}); "
          f"{out['workloads']} workloads priced against {out['chip']}")
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
