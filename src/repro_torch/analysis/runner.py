"""Analysis driver of the port: select passes, run them, assemble the
report (counterpart of ``repro.analysis.runner``).

Passes self-register at import time, so the runner imports the pass
modules lazily and only the ones whose declared rules survive the
``--rules`` filter.

A pass that *crashes* is itself a finding (``analysis-pass-error``,
severity error): an analyzer that silently skips a broken pass is
strictly worse than no analyzer.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence

from repro_torch.analysis.findings import Finding, Location, Report
from repro_torch.analysis.registry import (PRESETS, RULES, AnalysisContext,
                                           all_passes)

#: Pass modules, imported on demand (each registers itself).
_PASS_MODULES = (
    "repro_torch.analysis.kernel_validator",
    "repro_torch.analysis.graph_lint",
    "repro_torch.analysis.contracts",
    "repro_torch.analysis.ast_lint",
    "repro_torch.analysis.liveness",
    "repro_torch.analysis.deploy_lint",
    "repro_torch.analysis.sharding_prop",
    "repro_torch.analysis.spmd_lint",
)


def _load_passes():
    import importlib
    for mod in _PASS_MODULES:
        importlib.import_module(mod)
    return all_passes()


def repo_root() -> str:
    """The checkout the package lives in: src/repro_torch -> <root>."""
    import repro_torch
    pkg_dir = os.path.dirname(os.path.abspath(repro_torch.__file__))
    return os.path.dirname(os.path.dirname(pkg_dir))


def run_analysis(preset: str = "ci",
                 rules: Optional[Sequence[str]] = None,
                 root: Optional[str] = None) -> Report:
    """Run every pass whose rules intersect ``rules`` (None = all)."""
    if preset not in PRESETS:
        raise KeyError(f"unknown analysis preset {preset!r}; "
                       f"available: {sorted(PRESETS)}")
    if rules:
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            raise KeyError(f"unknown rule ids {unknown}; "
                           f"see --list-rules")
    selected = set(rules) if rules else None

    ctx = AnalysisContext(preset=PRESETS[preset], root=root or repo_root())
    report = Report(preset=preset,
                    rules=sorted(selected) if selected else None)
    for name, ps in sorted(_load_passes().items()):
        if selected is not None and not selected.intersection(ps.rules):
            continue
        t0 = time.time()
        try:
            found: List[Finding] = list(ps.run(ctx))
        except Exception as e:
            found = [Finding(
                "analysis-pass-error", "error", Location(symbol=name),
                f"pass crashed: {type(e).__name__}: {e}",
                "fix the pass — a skipped sanitizer is a false all-clear")]
        if selected is not None:
            # a crashed pass must never be filtered into silence — a
            # skipped sanitizer reads as a false all-clear
            found = [f for f in found
                     if f.rule_id in selected
                     or f.rule_id == "analysis-pass-error"]
        report.findings.extend(found)
        report.passes[name] = {
            "rules": list(ps.rules),
            "findings": len(found),
            "seconds": round(time.time() - t0, 3),
        }
    return report
