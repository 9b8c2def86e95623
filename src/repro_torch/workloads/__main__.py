"""Workload CLI.

    PYTHONPATH=src python -m repro_torch.workloads list [--frontend cnn|lm]
    PYTHONPATH=src python -m repro_torch.workloads show vgg16 [--input-size 384]
    PYTHONPATH=src python -m repro_torch.workloads show minicpm-2b/train_4k

``diff`` (the traced-vs-analytic cross-check) exits 2 with the reason:
the trace front-end it needs is not ported yet.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.core.workload.registry import TRACE_PENDING
from repro_torch.workloads import get_workload, list_workloads


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _table(rows, keys=None) -> None:
    if not rows:
        return
    keys = keys or list(rows[0].keys())
    widths = {k: max(len(k), *(len(_fmt(r.get(k, ""))) for r in rows))
              for k in keys}
    print("  ".join(k.ljust(widths[k]) for k in keys))
    for r in rows:
        print("  ".join(_fmt(r.get(k, "")).ljust(widths[k]) for k in keys))


def cmd_list(args) -> int:
    rows = list_workloads()
    if args.frontend:
        rows = [r for r in rows if r["frontend"] == args.frontend]
    _table(rows, ["name", "frontend", "description"])
    print(f"\n{len(rows)} workload specs "
          f"(parametric '<arch>/<shape>' rows expand per shape kwargs)")
    return 0


def cmd_show(args) -> int:
    # --input-size is a CNN-frontend knob, --kv-len an LM knob;
    # reject the mismatched flag instead of crashing in the builder
    is_lm = "/" in args.spec
    kw = {}
    if args.input_size:
        if is_lm:
            print(f"error: --input-size does not apply to LM "
                  f"workload {args.spec!r}", file=sys.stderr)
            return 2
        kw["input_size"] = args.input_size
    if args.kv_len:
        if not is_lm:
            print(f"error: --kv-len does not apply to CNN workload "
                  f"{args.spec!r}", file=sys.stderr)
            return 2
        kw["kv_len"] = args.kv_len
    try:
        wl = get_workload(args.spec, **kw)
    except TypeError as e:
        # parametric builders (e.g. conv_case) need kwargs the CLI does
        # not expose — point at the python API instead of a traceback
        print(f"error: cannot build {args.spec!r} from the CLI ({e}); "
              f"use repro_torch.core.workload.get_workload("
              f"{args.spec!r}, ...) "
              f"with the kwargs named in `repro_torch.workloads list`",
              file=sys.stderr)
        return 2
    s = wl.summary()
    print(wl.describe())
    for k, v in sorted(wl.meta.items()):
        print(f"  meta.{k} = {v}")
    print(f"  model_flops = {wl.model_flops():.4g}  "
          f"flops_by_kind = {s['flops_by_kind']}")
    print()
    rows = [{
        "op": o.name, "kind": o.kind, "gflop": o.flops / 1e9,
        "weight_mb": o.weight_bytes / 1e6,
        "act_mb": (o.act_in_bytes + o.act_out_bytes) / 1e6,
        "intensity": o.intensity,
        "axis": o.weight_axis or "-", "width": o.width,
    } for o in wl.ops]
    if args.limit and len(rows) > args.limit:
        shown = rows[:args.limit]
        _table(shown)
        print(f"... ({len(rows) - args.limit} more ops; --limit 0 for all)")
    else:
        _table(rows)
    return 0


def cmd_diff(args) -> int:
    print(f"error: diff: {TRACE_PENDING}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.workloads")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list", help="list registered workloads")
    p.add_argument("--frontend", default=None,
                   choices=["cnn", "lm", "custom"])
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("show", help="per-op table for one workload")
    p.add_argument("spec", help="e.g. vgg16, minicpm-2b/train_4k")
    p.add_argument("--input-size", type=int, default=None)
    p.add_argument("--kv-len", type=int, default=None)
    p.add_argument("--limit", type=int, default=40,
                   help="max op rows to print (0 = all)")
    p.set_defaults(fn=cmd_show)

    p = sub.add_parser("diff",
                       help="traced vs analytic cross-check (not ported)")
    p.add_argument("--model", required=True)
    p.add_argument("--shape", required=True)
    p.set_defaults(fn=cmd_diff)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
