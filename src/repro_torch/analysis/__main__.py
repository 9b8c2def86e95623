"""CLI: ``python -m repro_torch.analysis --preset ci|h100 [--rules ...]
[--strict] [--output PATH] [--baseline PATH] [--list-rules]``.

Exit code 0 when no ``error`` findings (and no ``warning`` under
``--strict``); 1 otherwise; 2 on a usage error (an unknown rule or an
unreadable baseline). With ``--baseline`` the gate is the *diff*
instead: only rules whose error/warning count grew past the baseline
fail the run. The report always lands at the port's
``analysis/report.json`` under ``$REPRO_TORCH_ARTIFACT_DIR`` (default
``artifacts/torch``; ``--output`` overrides), failing runs included.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis.findings import (baseline_regressions, gate_counts,
                                           load_baseline)
from repro_torch.analysis.registry import PRESETS, RULES
from repro_torch.analysis.runner import run_analysis
from repro_torch.artifacts import (analysis_baseline_path,
                                   analysis_report_path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="ci", choices=sorted(PRESETS),
                    help="analysis scale: " + "; ".join(
                        f"{n}: {p.description}" for n, p in
                        sorted(PRESETS.items())))
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids; passes emitting none "
                         "of them are skipped entirely")
    ap.add_argument("--strict", action="store_true",
                    help="warnings also fail the run")
    ap.add_argument("--output", "--out", dest="output", default=None,
                    help=f"report path (default {analysis_report_path()})")
    ap.add_argument("--baseline", default=None, metavar="PATH",
                    help="diff against this baseline: fail only on rules "
                         "whose error/warning count grew")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    dest="write_baseline",
                    help="also write the run's gate counts as a fresh "
                         f"baseline (e.g. {analysis_baseline_path()})")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, desc in sorted(RULES.items()):
            print(f"{rid:28s} {desc}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    try:
        report = run_analysis(args.preset, rules=rules)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2

    path = report.write(args.output or analysis_report_path())
    counts = report.counts()
    for f in report.findings:
        print(f.describe(), file=sys.stderr)
    print(f"[analysis/{args.preset}] {len(report.findings)} findings "
          f"({counts['error']} errors, {counts['warning']} warnings, "
          f"{counts['info']} info) across {len(report.passes)} passes "
          f"-> {path}")

    if args.write_baseline:
        bpath = report.write_baseline(args.write_baseline)
        print(f"[analysis/{args.preset}] baseline -> {bpath}")

    if args.baseline:
        try:
            base = load_baseline(args.baseline)
        except (OSError, ValueError) as e:
            print(f"error: cannot read baseline {args.baseline!r}: {e}",
                  file=sys.stderr)
            return 2
        regressions = baseline_regressions(
            gate_counts(report.findings), base)
        for r in regressions:
            print(f"[regression vs baseline] {r}", file=sys.stderr)
        print(f"[analysis/{args.preset}] baseline diff vs "
              f"{args.baseline}: {len(regressions)} regressed rules")
        return 1 if regressions else 0

    return report.exit_code(strict=args.strict)


if __name__ == "__main__":
    sys.exit(main())
