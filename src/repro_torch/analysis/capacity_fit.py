"""Fit the capacity model's per-kind coefficients to measured peaks.

    PYTHONPATH=src python -m repro_torch.analysis.capacity_fit LOG [LOG ...]

Reads the ``[capacity] {json}`` lines ``chip_smoke.py`` prints (one per
served, prefilled and trained run on the card: the run's features, its
predicted argument bytes and peak, and its measured
``torch.cuda.max_memory_allocated``), fits each kind as the reference
fitted XLA's peaks: non-negative least squares over the kind's
:data:`~repro_torch.analysis.capacity.FIT_FEATURES`, each row divided by
its measured peak so that the residuals are relative errors. Prints the
coefficients (``one`` in units of 1e6 bytes, as the feature is); for
the fitted and for the current :data:`~repro_torch.analysis.capacity.
CALIBRATION` coefficients, the worst relative error per kind against
``PARITY_REL_TOL``; and the leave-one-out errors (each run against a fit
to the kind's other runs).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import numpy as np

from repro_torch.analysis.capacity import (CALIBRATION, FIT_FEATURES,
                                           PARITY_REL_TOL, predicted_peak)

TAG = "[capacity] "


def read_records(paths) -> List[dict]:
    """The ``[capacity]`` records of the given logs, in order."""
    out = []
    for path in paths:
        with open(path) as f:
            for line in f:
                if line.startswith(TAG + "{"):        # not the summaries
                    out.append(json.loads(line[len(TAG):]))
    return out


def fit(records: List[dict], features) -> Dict[str, float]:
    """nnls of the measured peaks on ``features``, relative-error
    weighted; features that take no weight are left out."""
    from scipy.optimize import nnls
    A = np.array([[r["features"].get(k, 0.0) / r["measured_bytes"]
                   for k in features] for r in records])
    x, _ = nnls(A, np.ones(len(records)))
    return {k: float(round(c, 4)) for k, c in zip(features, x) if c > 0}


def rel_errors(records: List[dict], coef: Dict[str, float]) -> List[float]:
    """|measured - predicted| / measured of each record under ``coef``."""
    return [abs(r["measured_bytes"] - predicted_peak(
        r["features"], coef, r["argument_bytes"])) / r["measured_bytes"]
        for r in records]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.capacity_fit")
    ap.add_argument("logs", nargs="+", help="chip_smoke.py outputs")
    args = ap.parse_args(argv)
    records = read_records(args.logs)
    if not records:
        print("no [capacity] lines", file=sys.stderr)
        return 2
    fitted = {}
    for kind, feats in FIT_FEATURES.items():
        rows = [r for r in records if r["kind"] == kind]
        if not rows:
            continue
        fitted[kind] = fit(rows, feats)
        # each run predicted by a fit to the others: what the kind's
        # runs say of a run they were not fitted to
        loo = [rel_errors([r], fit(rows[:i] + rows[i + 1:], feats))[0]
               for i, r in enumerate(rows)] if len(rows) > 1 else []
        if loo:
            print(f"{kind} leave-one-out: worst {max(loo):.4f}, mean "
                  f"{float(np.mean(loo)):.4f} over {len(rows)} runs")
        for label, coef in (("fitted", fitted[kind]),
                            ("current", CALIBRATION[kind])):
            errs = rel_errors(rows, coef)
            worst = int(np.argmax(errs))
            print(f"{kind} {label}: {len(rows)} runs over {len(feats)} "
                  f"features; worst |measured - predicted| / measured "
                  f"{errs[worst]:.4f} ({rows[worst]['arch']} "
                  f"{rows[worst]['engine']} {rows[worst]['kv_dtype']}), "
                  f"mean {float(np.mean(errs)):.4f}, bar {PARITY_REL_TOL}; "
                  f"{coef}")
    print(json.dumps(fitted, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
