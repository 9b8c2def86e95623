"""Contract checker: the cross-module invariants the port leans on (the
counterpart of ``repro.analysis.contracts``).

Three families of "distributed declarations" must stay in sync, and
nothing enforces them at runtime until something corrupts silently:

* **Cache axes** — every leaf ``cache_spec``/``paged_cache_spec`` can
  emit must be declared in ``CACHE_AXES``/``PAGED_CACHE_AXES`` at the
  right rank: the serving engines splice caches *by declared axis*, so an
  undeclared leaf is a KeyError at serve time.
* **Axis resolvability** — every logical axis name used by the cache
  and parameter trees (``CACHE_AXES``, ``PAGED_CACHE_AXES`` and each
  arch's ``axes_tree``) must be a key in every sharding recipe's rules
  (``dist.sharding.RECIPES``; :func:`check_axis_resolvable`):
  ``Recipe.spec_for`` silently replicates a name it does not know.
* **Dispatch closure** — every op in the kernel dispatch table needs a
  ``torch`` reference (the backward donor and parity oracle), a row in
  both tune presets' grids for each of its impls (or it is never
  swept/calibrated) and an entry in ``CALIB_OP_KIND`` (or its
  measurements never price workloads).

All checks take their inputs as arguments so tests can seed violations
without touching live tables; ``run_pass`` wires in the live ones.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

from repro_torch.analysis.findings import Finding, Location
from repro_torch.analysis.registry import AnalysisContext, register_pass

#: Families exercised by the cache-axes check (one per cache layout).
REPRESENTATIVE_ARCHS = ("minicpm-2b", "mamba2-1.3b", "zamba2-2.7b",
                        "qwen2-moe-a2.7b")

#: The op's reference implementation, which every kernel impl needs.
REFERENCE_IMPL = "torch"


# ---------------------------------------------------------------------------
# Cache leaves vs axis declarations
# ---------------------------------------------------------------------------
def check_cache_axes(spec: Mapping[str, Tuple[Tuple, Any]],
                     axes: Mapping[str, Tuple],
                     *, axes_name: str, symbol: str) -> List[Finding]:
    out: List[Finding] = []
    for leaf, (shape, _) in spec.items():
        if leaf not in axes:
            out.append(Finding(
                "contract-cache-axes", "error",
                Location(symbol=f"{symbol}/{leaf}"),
                f"cache leaf {leaf!r} is not declared in {axes_name} — "
                f"splicing and sharding cannot resolve its batch axis",
                f"add {leaf!r} to {axes_name} with one logical name per "
                f"dim (None = replicated)"))
            continue
        if len(axes[leaf]) != len(shape):
            out.append(Finding(
                "contract-cache-axes", "error",
                Location(symbol=f"{symbol}/{leaf}"),
                f"{axes_name}[{leaf!r}] declares {len(axes[leaf])} axes "
                f"but the spec shape has rank {len(shape)} ({shape})",
                "keep the declaration rank-exact with the spec"))
    return out


# ---------------------------------------------------------------------------
# Axis names vs recipe rules
# ---------------------------------------------------------------------------
def check_axis_resolvable(axis_names: Mapping[str, Tuple],
                          recipes: Mapping[str, Any],
                          *, source: str) -> List[Finding]:
    """Every non-None axis name in ``axis_names`` values must be a key
    of every recipe's rules (an explicit ``None`` rule means "replicate
    by design" — absence means "nobody decided")."""
    out: List[Finding] = []
    names = sorted({a for axes in axis_names.values() for a in axes
                    if a is not None})
    for name in names:
        missing = sorted(r for r, recipe in recipes.items()
                         if name not in recipe.rules)
        if missing:
            out.append(Finding(
                "contract-axis-unresolvable", "error",
                Location(symbol=f"{source}/{name}"),
                f"logical axis {name!r} (declared in {source}) is absent "
                f"from recipe rules {missing} — spec_for silently "
                f"replicates it",
                f"declare {name!r} in the recipes (a None rule records "
                f"replicate-by-design)"))
    return out


# ---------------------------------------------------------------------------
# Dispatch-table closure
# ---------------------------------------------------------------------------
def check_dispatch_closure(ops: Tuple[str, ...],
                           table: Mapping[str, Mapping[str, Any]],
                           tune_presets: Mapping[str, Any],
                           calib_kinds: Mapping[str, str]) -> List[Finding]:
    out: List[Finding] = []
    ref = REFERENCE_IMPL
    for op in ops:
        impls = table.get(op, {})
        if ref not in impls:
            out.append(Finding(
                "contract-dispatch-ref", "error", Location(symbol=op),
                f"op {op!r} has no {ref!r} reference implementation — no "
                f"VJP donor, no parity oracle",
                f"register a {ref} impl before any kernel impl"))
        if op not in calib_kinds:
            out.append(Finding(
                "contract-calib-kind", "error", Location(symbol=op),
                f"op {op!r} missing from MeasuredModel.CALIB_OP_KIND — "
                f"its calibration entries never price workloads",
                "map the op to its Workload IR kind in CALIB_OP_KIND"))
        for pname, preset in tune_presets.items():
            for impl in impls:
                if not preset.grids.get(op, {}).get(impl):
                    out.append(Finding(
                        "contract-tune-grid", "error",
                        Location(symbol=f"{op}/{impl}"),
                        f"impl {op}/{impl} has no block-size grid in tune "
                        f"preset {pname!r} — it is never swept or "
                        f"calibrated",
                        f"add a grids[{op!r}][{impl!r}] row to the "
                        f"{pname} TunePreset"))
    return out


# ---------------------------------------------------------------------------
# Live-tree pass
# ---------------------------------------------------------------------------
def param_axis_names(cfg) -> Dict[str, Tuple]:
    """``{leaf path: logical axes}`` of an arch's parameter tree."""
    from repro_torch.models.model import axes_tree

    out: Dict[str, Tuple] = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}['{k}']")
        else:
            out[path] = tuple(tree or ())

    walk(axes_tree(cfg), "")
    return out


@register_pass(
    "contracts",
    rules=("contract-cache-axes", "contract-axis-unresolvable",
           "contract-dispatch-ref", "contract-tune-grid",
           "contract-calib-kind"),
    description="cache-axis declarations, recipe resolvability, "
                "dispatch/tune/calibration closure")
def run_pass(ctx: AnalysisContext) -> List[Finding]:
    from repro_torch.configs import ARCHS, get_arch, smoke_config
    from repro_torch.core.analytical.measured import CALIB_OP_KIND
    from repro_torch.dist.sharding import RECIPES
    from repro_torch.kernels.dispatch import KERNEL_OPS, implementations
    from repro_torch.kernels.tune import TUNE_PRESETS
    from repro_torch.models.model import (CACHE_AXES, PAGED_CACHE_AXES,
                                          _cache_window, cache_spec,
                                          page_count, paged_cache_spec)

    findings: List[Finding] = []
    max_len, ps = ctx.preset.max_len, ctx.preset.page_size
    for arch in REPRESENTATIVE_ARCHS:
        cfg = smoke_config(get_arch(arch))
        W = _cache_window(cfg, max_len)
        n_pages = 2 * page_count(W, ps) + 1
        for kvd in (None, "int8"):
            findings += check_cache_axes(
                cache_spec(cfg, 2, max_len, kv_dtype=kvd), CACHE_AXES,
                axes_name="CACHE_AXES", symbol=f"cache_spec/{arch}")
            findings += check_cache_axes(
                paged_cache_spec(cfg, 2, n_pages, ps, max_len,
                                 kv_dtype=kvd),
                PAGED_CACHE_AXES, axes_name="PAGED_CACHE_AXES",
                symbol=f"paged_cache_spec/{arch}")

    findings += check_axis_resolvable(CACHE_AXES, RECIPES,
                                      source="CACHE_AXES")
    findings += check_axis_resolvable(PAGED_CACHE_AXES, RECIPES,
                                      source="PAGED_CACHE_AXES")
    for arch in ARCHS:
        findings += check_axis_resolvable(
            param_axis_names(get_arch(arch)), RECIPES,
            source=f"axes_tree/{arch}")

    table = {op: implementations(op) for op in KERNEL_OPS}
    findings += check_dispatch_closure(KERNEL_OPS, table, TUNE_PRESETS,
                                       CALIB_OP_KIND)
    # one finding per (symbol, rule): the per-arch loops above can
    # rediscover the same gap
    seen, uniq = set(), []
    for f in findings:
        key = (f.rule_id, f.location.symbol, f.message)
        if key not in seen:
            seen.add(key)
            uniq.append(f)
    return uniq
