"""Hopper kernel validator: static checks over the kernels' launch plans
(the port's counterpart of ``repro.analysis.kernel_validator``).

For every registered non-``torch`` implementation in the kernel dispatch
table, take its launch plan (``fn.launch_plan``, a
``repro_torch.kernels.plan.KernelPlan``: nothing launches) at the
tune-preset shapes, on ``meta`` operands, and check the launch geometry
*numerically*, as the reference checks a captured ``pallas_call``:

* **coverage** — evaluating each output's block-to-tile map over every
  block of the grid must reach every tile the consumer reads, else part
  of the output is whatever was in memory (``kernel-grid-coverage``);
* **write race** — two blocks writing one output tile is legal only when
  the launch *declares* accumulation (``Launch.accumulates``, the
  counterpart of a scratch carry or an output-ref read); blocks of a CUDA
  grid run concurrently, so an undeclared revisit is a data race
  (``kernel-write-race``);
* **shared-memory budget** — a block's static plus dynamic shared memory
  must fit the card's opt-in limit (227 KiB on sm_90), its threads
  1,024, and gridDim.y and .z 65,535, or the launch fails on the card
  (``kernel-smem-budget``, the counterpart of ``kernel-vmem-budget``);
* **differentiability** — the op's ``torch`` implementation, whose
  autograd ``dispatch._RefBackward`` borrows, must exist and its autograd
  run on ``meta`` for the float operands (``kernel-missing-vjp``);
* **parity** — the plan's result shapes and dtypes, and the outputs of
  the impl's own ``meta`` path (the wrapper's checks and allocations,
  nothing launched: ``dispatch.meta_launch``), must match the ``torch``
  implementation's, run on ``meta`` (``kernel-dtype-parity``).

Grids above ``_MAX_GRID_CELLS`` blocks skip the vectorised coverage/race
evaluation (the tune-grid shapes never get close).

Besides the tune grid, the pass validates the shapes a rank of a mesh
gives the grouped expert GEMM and the SSD scan at full width
(:func:`mesh_cases`: qwen2-moe's 15 experts a rank at ``model`` 4 and
176 columns of each at ``model`` 8, the SSD heads of mamba2 at ``model``
2 and 4 and of zamba2 at 2), read off ``dist.sharding.Placement``.

``python -m repro_torch.analysis.kernel_validator`` runs the pass over a
tune preset; with ``--sanitize`` (on the card) it launches each kernel
once at the ``ci`` preset's small shapes, in f32 and bf16, with every
buffer the wrappers allocate filled with NaN first, and holds each output
to its plain version: an output element no block writes stays NaN and
fails the comparison. It is the target ``chip_smoke.py`` runs under
``compute-sanitizer`` where that tool runs.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.analysis.findings import Finding, Location
from repro_torch.analysis.registry import (SMEM_BUDGET_BYTES,
                                           AnalysisContext, register_pass)
from repro_torch.kernels import plan as P

_MAX_GRID_CELLS = 4_000_000


# ===========================================================================
# Geometry checks on one launch
# ===========================================================================
def _tile_ids(out: P.Output, coords: List[np.ndarray], ncells: int,
              needed) -> Optional[np.ndarray]:
    coords = [np.broadcast_to(np.asarray(c), (ncells,)).astype(np.int64)
              for c in coords]
    if len(coords) != len(needed):
        return None
    live = coords[0] >= 0
    return np.ravel_multi_index(
        [np.clip(c[live], 0, n - 1) for c, n in zip(coords, needed)], needed)


def check_plan(launch: P.Launch, *, smem_budget: int = SMEM_BUDGET_BYTES,
               label: str) -> List[Finding]:
    """Coverage, race and budget findings of one launch."""
    findings: List[Finding] = []
    grid = tuple(int(g) for g in launch.grid)
    ncells = int(np.prod(grid, dtype=np.int64))

    # -- coverage + write race ----------------------------------------------
    if 0 < ncells <= _MAX_GRID_CELLS and launch.outputs:
        mesh = np.meshgrid(*[np.arange(g) for g in grid], indexing="ij")
        bx, by, bz = (m.ravel() for m in mesh)
        for i, out in enumerate(launch.outputs):
            needed = out.tile_grid
            try:
                slots = out.tiles(bx, by, bz)
            except Exception:                     # an unevaluable map
                continue
            parts = [_tile_ids(out, list(c), ncells, needed) for c in slots]
            if not parts or any(p is None for p in parts):
                continue
            ids = np.concatenate(parts)
            uniq = np.unique(ids)
            required = (np.ones(needed, dtype=bool) if out.required is None
                        else np.asarray(out.required, dtype=bool)
                        .reshape(needed))
            total = int(required.sum())
            covered = int(required.ravel()[uniq].sum())
            sym = f"{label}#{launch.kernel}/{out.name}"
            if covered < total:
                findings.append(Finding(
                    "kernel-grid-coverage", "error", Location(symbol=sym),
                    f"grid {grid} reaches {covered}/{total} tiles of output "
                    f"{i} {out.name!r} (shape {out.shape}, tile {out.tile}) "
                    f"— uncovered tiles are uninitialized memory",
                    "extend the grid or fix the output tile map"))
            if ids.size > uniq.size and not launch.accumulates:
                findings.append(Finding(
                    "kernel-write-race", "error", Location(symbol=sym),
                    f"{ids.size} block writes land on {uniq.size} tiles of "
                    f"output {i} {out.name!r} without declared "
                    f"accumulation — concurrent blocks overwrite each "
                    f"other",
                    "give each block its own tile, or accumulate "
                    "(atomics or a separate reduction) and declare it"))

    # -- shared memory, threads, grid extents ---------------------------------
    over = []
    smem = int(launch.smem_static) + int(launch.smem_dynamic)
    if smem > smem_budget:
        over.append(f"static {launch.smem_static} + dynamic "
                    f"{launch.smem_dynamic} B of shared memory a block "
                    f"exceed the {smem_budget} B opt-in limit")
    if launch.threads > P.MAX_BLOCK_THREADS:
        over.append(f"block {tuple(launch.block)} has {launch.threads} "
                    f"threads, over {P.MAX_BLOCK_THREADS}")
    if max(grid[1:]) > P.MAX_GRID_YZ:
        over.append(f"grid {grid} exceeds {P.MAX_GRID_YZ} in y or z")
    if over:
        findings.append(Finding(
            "kernel-smem-budget", "error",
            Location(symbol=f"{label}#{launch.kernel}"), "; ".join(over),
            "shrink the tile in the tune grid, or fold the extent into "
            "gridDim.x"))
    return findings


# ===========================================================================
# One implementation at one shape
# ===========================================================================
def _leaves(out: Any) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _leaves(o)]
    return []


def _meta_copy(a: Any, grad: bool = False) -> Any:
    if not isinstance(a, torch.Tensor):
        return a
    t = torch.empty(a.shape, dtype=a.dtype, device="meta")
    return t.requires_grad_(grad and a.dtype.is_floating_point)


def _grad_error(ref: Callable, args: Sequence[Any],
                kwargs: Dict[str, Any]) -> Optional[str]:
    """Run the reference's autograd on ``meta`` for the float operands;
    None if it runs, else the failure message."""
    copies = [_meta_copy(a, grad=True) for a in args]
    diff = [a for a in copies
            if isinstance(a, torch.Tensor) and a.requires_grad]
    if not diff:
        return None
    try:
        with torch.enable_grad():
            outs = [o for o in _leaves(ref(*copies, **kwargs))
                    if o.dtype.is_floating_point and o.requires_grad]
            if not outs:
                return "no differentiable output"
            total = sum(o.float().sum() for o in outs)
            torch.autograd.grad(total, diff, allow_unused=True)
        return None
    except Exception as e:                      # ran, and failed
        return f"{type(e).__name__}: {e}"


def _parity(label: str, what: str, got, want) -> List[Finding]:
    if got == want:
        return []
    return [Finding(
        "kernel-dtype-parity", "error", Location(symbol=label),
        f"{what} outputs {got} but the torch reference produces {want}",
        "match the reference signature exactly — dispatch treats "
        "implementations as interchangeable")]


def validate_impl(op: str, impl: str, fn: Callable, args: Sequence[Any],
                  kwargs: Dict[str, Any], *, ref: Optional[Callable] = None,
                  smem_budget: int = SMEM_BUDGET_BYTES,
                  label: Optional[str] = None,
                  plan_only: bool = False) -> List[Finding]:
    """Every static check for one (impl, shape, tuning-params) point.

    ``args`` are the operands (``meta`` tensors, or any whose shapes and
    dtypes stand for them); nothing launches. ``ref`` is the op's
    ``torch`` implementation: parity and its autograd are checked on
    ``meta`` copies, and its absence is itself a ``kernel-missing-vjp``
    finding (the kernels are forward-only and borrow its backward).
    ``plan_only`` checks the launch plan alone (registration: a process's
    first op on ``meta`` imports ``torch._dynamo``, about a second).
    Parity also calls ``fn`` itself on ``meta`` copies (a kernel
    wrapper's meta branch) and holds its outputs to the reference's.
    """
    label = label or f"{op}/{impl}"
    findings: List[Finding] = []
    plan_of = getattr(fn, "launch_plan", None)
    try:
        if plan_of is None:
            raise TypeError("the impl declares no launch plan")
        plan = plan_of(*args, **kwargs)
    except Exception as e:
        return [Finding(
            "kernel-trace-error", "error", Location(symbol=label),
            f"launch plan failed at {kwargs or 'default params'}: "
            f"{type(e).__name__}: {e}",
            "the impl must plan (and launch) at every tune-grid point")]
    for launch in plan.launches:
        findings.extend(check_plan(launch, smem_budget=smem_budget,
                                   label=label))
    if plan_only:
        return findings

    # -- parity vs reference -------------------------------------------------
    if ref is not None:
        try:
            with torch.no_grad():
                ref_out = ref(*[_meta_copy(a) for a in args], **kwargs)
        except Exception as e:
            ref_out = None
            findings.append(Finding(
                "kernel-trace-error", "error", Location(symbol=label),
                f"torch reference failed on meta: {type(e).__name__}: {e}"))
        if ref_out is not None:
            want = [(tuple(t.shape), str(t.dtype)) for t in _leaves(ref_out)]
            got = [(tuple(s), str(d)) for s, d in plan.results]
            findings.extend(_parity(label, "impl", got, want))
            try:
                with torch.no_grad():
                    meta_out = fn(*[_meta_copy(a) for a in args], **kwargs)
            except Exception as e:
                findings.append(Finding(
                    "kernel-trace-error", "error", Location(symbol=label),
                    f"the impl's meta path failed: {type(e).__name__}: {e}",
                    "a wrapper given meta tensors runs its checks and "
                    "returns empty outputs"))
            else:
                got = [(tuple(t.shape), str(t.dtype), t.device.type)
                       for t in _leaves(meta_out)]
                findings.extend(_parity(
                    label, "impl's meta path", got,
                    [w + ("meta",) for w in want]))

    # -- differentiability ---------------------------------------------------
    if ref is None:
        findings.append(Finding(
            "kernel-missing-vjp", "error", Location(symbol=label),
            "impl has no torch reference to borrow a backward pass from — "
            "it cannot reach the train path",
            "register a torch impl for the op"))
    else:
        err = _grad_error(ref, args, kwargs)
        if err:
            findings.append(Finding(
                "kernel-missing-vjp", "error", Location(symbol=label),
                f"the torch reference's autograd fails on meta: {err}",
                "the torch reference must be differentiable at the impl's "
                "signature"))
    return findings


# ===========================================================================
# Preset sweep + registered pass
# ===========================================================================
def validate_preset(tune_preset, cells=None, *,
                    smem_budget: int = SMEM_BUDGET_BYTES) -> List[Finding]:
    """Validate every non-torch impl over a tune preset's cases × grids,
    on ``meta`` operands."""
    from repro_torch.kernels.dispatch import implementations
    from repro_torch.kernels.tune import cases_for_cell

    findings: List[Finding] = []
    seen = set()
    for arch, shape_name in (cells or tune_preset.cells):
        cfg = tune_preset.arch(arch)
        shape = tune_preset.shape(shape_name)
        for case in cases_for_cell(cfg, shape,
                                   bench_batch=tune_preset.bench_batch,
                                   page_sizes=tune_preset.paged_page_sizes,
                                   device="meta"):
            args = case.make_args()
            impls = implementations(case.op)
            ref = impls.get("torch")
            for impl in sorted(impls):
                if impl == "torch":
                    continue
                for params in tune_preset.grid(case.op, impl):
                    label = f"{case.op}/{impl}@{arch}/{shape_name}"
                    fs = validate_impl(
                        case.op, impl, impls[impl], args,
                        {**case.kwargs, **dict(params)}, ref=ref,
                        smem_budget=smem_budget, label=label)
                    for f in fs:
                        key = (f.rule_id, f.location.symbol, f.message)
                        if key not in seen:
                            seen.add(key)
                            findings.append(f)
    return findings


#: (arch, ``model`` size) of the per-rank kernel shapes
#: :func:`mesh_cases` plans: expert-parallel and expert-split MoE,
#: head-aligned Mamba-2.
MESH_KERNEL_CELLS = (("qwen2-moe-a2.7b", 4), ("qwen2-moe-a2.7b", 8),
                     ("mamba2-1.3b", 2), ("mamba2-1.3b", 4),
                     ("zamba2-2.7b", 2))


def mesh_cases(dtype=torch.bfloat16):
    """``(op, label, args, kwargs)`` on ``meta`` of the grouped expert
    GEMM (decode rows, 4 slots x top-k, and a 1024-token prefill's; the
    gate/up and the down shape) and the SSD scan (B1 S1024) at the shapes
    a rank of a (1, M) mesh runs them at full width under the decode
    recipe."""
    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import DECODE_RECIPE, Placement
    from repro_torch.models.ssm import ssm_dims

    def meta(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    out = []
    for arch, model in MESH_KERNEL_CELLS:
        cfg = get_arch(arch)
        pl = Placement(cfg, DECODE_RECIPE, {"data": 1, "model": model})
        where = f"{arch} at model {model}"
        if cfg.moe is not None:
            m, d = cfg.moe, cfg.d_model
            E = pl.n_experts
            f = m.d_expert // (model if pl.moe_split == "ffn" else 1)
            for T in (4 * m.experts_per_token, 1024 * m.experts_per_token):
                for d_in, d_out in ((d, f), (f, d)):
                    out.append(("moe_gemm", f"{where}: E {E} f {f}, T{T} "
                                f"{d_in}->{d_out}",
                                (meta(T, d_in), meta(E, d_in, d_out),
                                 meta(T, dt=torch.int32)), {"n_experts": E}))
        else:
            dm = ssm_dims(cfg)
            nh, hp, N, S = pl.ssm_heads, dm["hp"], dm["N"], 1024
            out.append(("ssd_scan", f"{where}: nh {nh} hp {hp} N {N}, B1 "
                        f"S{S}", (meta(1, S, nh, hp),
                                  meta(1, S, nh, dt=torch.float32),
                                  meta(nh, dt=torch.float32),
                                  meta(1, S, nh, N), meta(1, S, nh, N)),
                        {"chunk": cfg.ssm.chunk_size}))
    return out


def validate_mesh_cases(*, smem_budget: int = SMEM_BUDGET_BYTES
                        ) -> List[Finding]:
    """Every non-torch impl of :func:`mesh_cases`' ops at their shapes,
    on ``meta`` operands."""
    from repro_torch.kernels.dispatch import implementations
    findings: List[Finding] = []
    for op, label, args, kw in mesh_cases():
        impls = implementations(op)
        for impl in sorted(impls):
            if impl != "torch":
                findings.extend(validate_impl(
                    op, impl, impls[impl], args, kw, ref=impls.get("torch"),
                    smem_budget=smem_budget, label=f"{op}/{impl}@{label}"))
    return findings


@register_pass(
    "kernel_validator",
    rules=("kernel-grid-coverage", "kernel-write-race", "kernel-smem-budget",
           "kernel-missing-vjp", "kernel-dtype-parity", "kernel-trace-error"),
    description="coverage/race/shared-memory/VJP/parity checks on the "
                "launch plan of every registered non-torch kernel over "
                "the tune-grid shapes and the per-rank mesh shapes")
def run_pass(ctx: AnalysisContext) -> List[Finding]:
    from repro_torch.kernels.tune import TUNE_PRESETS
    budget = ctx.preset.smem_budget_bytes
    return (validate_preset(TUNE_PRESETS[ctx.preset.tune_preset],
                            smem_budget=budget)
            + validate_mesh_cases(smem_budget=budget))


# ===========================================================================
# The card-side target: every kernel once, outputs poisoned first
# ===========================================================================
#: cuda vs torch at the ci preset's shapes: f32 differs in summation
#: order only (TF32 off), relative to the output's RMS as the tuner's
#: check; bf16 rounds both sides' f32 results once, a few ulps apart.
SANITIZE_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
                torch.bfloat16: dict(atol=2e-2, rtol=2 ** -6)}


@contextlib.contextmanager
def poisoned_allocations():
    """Within the block, ``torch.empty`` and ``torch.empty_like`` of a
    float dtype return NaN-filled tensors: a kernel that leaves part of
    its output (or workspace) unwritten then leaves NaN behind."""
    real_empty, real_like = torch.empty, torch.empty_like

    def poison(t):
        if t.dtype.is_floating_point:
            t.fill_(float("nan"))
        return t

    torch.empty = lambda *a, **k: poison(real_empty(*a, **k))
    torch.empty_like = lambda *a, **k: poison(real_like(*a, **k))
    try:
        yield
    finally:
        torch.empty, torch.empty_like = real_empty, real_like


#: Operands whose dtype a kernel fixes at f32 (the SSD scan's dt and A).
F32_OPERANDS = {"ssd_scan": (1, 2)}


def _as_dtype(op, args, dtype):
    """The case's f32 operands of two or more dims in ``dtype`` (the
    activations, caches and weights), but those of :data:`F32_OPERANDS`;
    the vectors (norm and weight scales) stay f32."""
    keep = F32_OPERANDS.get(op, ())
    return tuple(a.to(dtype) if isinstance(a, torch.Tensor)
                 and a.dtype == torch.float32 and a.dim() > 1
                 and i not in keep else a for i, a in enumerate(args))


def sanitize(log: Callable[[str], None] = print) -> int:
    """Launch every ``cuda`` impl once per case of the ``ci`` tune preset
    on the card, in f32 and bf16 (the bf16 bodies on the tensor cores),
    with poisoned allocations; returns the number of failed checks."""
    from repro_torch.kernels.dispatch import KERNEL_OPS, implementations
    from repro_torch.kernels.tune import CI, cases_for_cell

    torch.backends.cuda.matmul.allow_tf32 = False
    failed, seen = 0, set()
    for arch, shape_name in CI.cells:
        for case in cases_for_cell(CI.arch(arch), CI.shape(shape_name),
                                   page_sizes=CI.paged_page_sizes[:1],
                                   device="cuda"):
            base = case.make_args()
            impls = implementations(case.op)
            for dtype in (torch.float32, torch.bfloat16):
                args = base if dtype == torch.float32 else \
                    _as_dtype(case.op, base, dtype)
                with poisoned_allocations():
                    got = impls["cuda"](*args, **case.kwargs)
                    torch.cuda.synchronize()
                want = impls["torch"](*args, **case.kwargs)
                tol = SANITIZE_TOL[dtype]
                ok, worst = True, 0.0
                for g, w in zip(_leaves(got), _leaves(want)):
                    g, w = g.float(), w.float()
                    rms = max(1.0, float(w.square().mean().sqrt()))
                    err = float((g - w).abs().max()) / rms \
                        if g.numel() else 0.0
                    finite = bool(torch.isfinite(g).all())
                    close = bool(torch.allclose(g, w, atol=tol["atol"] * rms,
                                                rtol=tol["rtol"]))
                    ok &= finite and close and g.shape == w.shape
                    worst = max(worst, err if finite else float("inf"))
                failed += not ok
                seen.add(case.op)
                log(f"[sanitize] {arch}/{shape_name} {case.op} "
                    f"{str(dtype)[6:]}: max|cuda - torch| / max(1, rms) "
                    f"{worst:.3e} {'ok' if ok else 'FAILED'}")
    missing = sorted(set(KERNEL_OPS) - seen)
    if missing:
        log(f"[sanitize] ops not launched: {missing}")
        failed += len(missing)
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.kernel_validator",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="ci",
                    help="tune preset whose grid is validated (ci, h100)")
    ap.add_argument("--sanitize", action="store_true",
                    help="on the card: launch every kernel once, outputs "
                         "poisoned, against its plain version")
    args = ap.parse_args(argv)
    if args.sanitize:
        if not torch.cuda.is_available():
            print("error: --sanitize launches the kernels: no CUDA device",
                  file=sys.stderr)
            return 2
        failed = sanitize()
        print(f"[sanitize] {failed} failed checks")
        return 1 if failed else 0
    from repro_torch.kernels.tune import TUNE_PRESETS
    findings = validate_preset(TUNE_PRESETS[args.preset]) \
        + validate_mesh_cases()
    for f in findings:
        print(f.describe())
    errors = sum(f.severity == "error" for f in findings)
    print(f"[kernel_validator/{args.preset}] {len(findings)} findings, "
          f"{errors} errors")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
