"""Workload CLI.

    PYTHONPATH=src python -m repro_torch.workloads list \
        [--frontend cnn|lm|torch_trace]
    PYTHONPATH=src python -m repro_torch.workloads show vgg16 [--input-size 384]
    PYTHONPATH=src python -m repro_torch.workloads show minicpm-2b/train_4k
    PYTHONPATH=src python -m repro_torch.workloads show \
        trace:minicpm-2b/train_4k
    PYTHONPATH=src python -m repro_torch.workloads diff --model minicpm_2b \
        --shape train_4k [--tol 0.05] [--kv-len N]

``diff`` traces the port's model for the cell (abstractly, on ``meta``)
and cross-checks its per-op FLOPs/bytes against the analytic LM
front-end; it exits non-zero when the weight-matmul FLOPs disagree
beyond ``--tol`` — the tracer is a standing validation of the
analytical profile (and vice versa).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.workloads import (
    diff_workloads,
    get_workload,
    list_workloads,
    lm_workload,
    resolve_arch,
    resolve_shape,
    trace_workload,
)


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
    # --input-size is a CNN-frontend knob, --kv-len an LM/trace knob;
    # reject the mismatched flag instead of crashing in the builder
    is_lm = "/" in args.spec
    kw = {}
    if args.input_size:
        if is_lm:
            print(f"error: --input-size does not apply to LM/trace "
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
    arch = resolve_arch(args.model)
    shape = resolve_shape(args.shape)
    analytic = lm_workload(arch, shape, kv_len=args.kv_len)
    traced = trace_workload(arch, shape, kv_len=args.kv_len)
    d = diff_workloads(analytic, traced)

    print(f"diff {d['traced']} vs {d['analytic']}")
    rows = [
        {"quantity": "weight-matmul GFLOP",
         "analytic": d["matmul_flops_analytic"] / 1e9,
         "traced": d["matmul_flops_traced"] / 1e9,
         "traced/analytic": d["matmul_ratio"]},
        {"quantity": "activation-dot GFLOP",
         "analytic": d["activation_flops_analytic"] / 1e9,
         "traced": d["activation_flops_traced"] / 1e9,
         "traced/analytic": d["activation_ratio"]},
        {"quantity": "weight GB",
         "analytic": d["weight_bytes_analytic"] / 1e9,
         "traced": d["weight_bytes_traced"] / 1e9,
         "traced/analytic": d["weight_bytes_ratio"]},
    ]
    _table(rows)
    print("\ntraced weight-matmul ops:")
    _table(d["traced_matmul_ops"])
    if d["while_loops"]:
        print(f"note: {d['while_loops']} while-loop(s) counted once "
              f"(trace is a lower bound there)")
    err = abs(d["matmul_ratio"] - 1.0)
    agree = err <= args.tol
    print(f"\nweight-matmul FLOPs {'agree' if agree else 'DISAGREE'}: "
          f"traced/analytic = {d['matmul_ratio']:.4f} "
          f"(|err| {err * 100:.2f}% vs tol {args.tol * 100:.0f}%)")
    if d["activation_ratio"] not in (0.0, 1.0):
        print(f"activation-dot ratio {d['activation_ratio']:.2f} — "
              f"expected where the executable computes masked/padded "
              f"work the analytic profile skips (causal halving, MoE "
              f"capacity, SSD chunking)")
    return 0 if agree else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.workloads")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list", help="list registered workloads")
    p.add_argument("--frontend", default=None,
                   choices=["cnn", "lm", "torch_trace", "custom"])
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("show", help="per-op table for one workload")
    p.add_argument("spec", help="e.g. vgg16, minicpm-2b/train_4k, "
                                "trace:minicpm-2b/train_4k")
    p.add_argument("--input-size", type=int, default=None)
    p.add_argument("--kv-len", type=int, default=None)
    p.add_argument("--limit", type=int, default=40,
                   help="max op rows to print (0 = all)")
    p.set_defaults(fn=cmd_show)

    p = sub.add_parser("diff",
                       help="torch-traced vs analytic cross-check")
    p.add_argument("--model", required=True)
    p.add_argument("--shape", required=True)
    p.add_argument("--kv-len", type=int, default=None)
    p.add_argument("--tol", type=float, default=0.05,
                   help="allowed |traced/analytic - 1| for weight-matmul "
                        "FLOPs (default 5%%)")
    p.set_defaults(fn=cmd_diff)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
