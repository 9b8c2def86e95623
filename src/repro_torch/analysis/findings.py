"""Findings model for the port's static-analysis subsystem (a copy of
the reference's ``repro.analysis.findings``).

Every analysis pass reduces to a list of :class:`Finding` records —
``(rule_id, severity, location, message, suggestion)`` — collected into
a :class:`Report` that serializes to the port's analysis report
(``repro_torch.artifacts.analysis_report_path``) and decides the process
exit code: non-zero on any ``error``, and on ``warning`` too under
``--strict``.

Suppression: a finding anchored to a file line is dropped when that
line carries an inline ``# repro: ignore[rule-id] -- justification``
comment. The justification is mandatory — an ignore comment without one
does *not* suppress and instead surfaces as an ``analysis-suppression``
warning, so waivers stay reviewable.
"""
from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

SEVERITIES = ("error", "warning", "info")

#: Inline-waiver syntax: ``# repro: ignore[rule-a,rule-b] -- why it is safe``.
IGNORE_RE = re.compile(
    r"#\s*repro:\s*ignore\[([A-Za-z0-9_\-, ]+)\]\s*(.*)$")

#: Minimum non-punctuation characters for a justification to count.
_MIN_JUSTIFICATION = 8


@dataclass(frozen=True)
class Location:
    """Where a finding anchors. ``file``/``line`` when source-anchored
    (AST lint), ``symbol`` for semantic findings (an op/impl pair, a
    traced function, a cache leaf)."""

    file: Optional[str] = None
    line: Optional[int] = None
    symbol: Optional[str] = None

    def describe(self) -> str:
        if self.file is not None:
            loc = self.file if self.line is None else f"{self.file}:{self.line}"
            return f"{loc} ({self.symbol})" if self.symbol else loc
        return self.symbol or "<global>"


@dataclass(frozen=True)
class Finding:
    rule_id: str
    severity: str
    location: Location
    message: str
    suggestion: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity must be one of {SEVERITIES}, "
                             f"got {self.severity!r}")

    def describe(self) -> str:
        s = f"[{self.severity}] {self.rule_id} {self.location.describe()}: " \
            f"{self.message}"
        if self.suggestion:
            s += f" (fix: {self.suggestion})"
        return s

    def to_json(self) -> Dict[str, Any]:
        return {
            "rule_id": self.rule_id,
            "severity": self.severity,
            "file": self.location.file,
            "line": self.location.line,
            "symbol": self.location.symbol,
            "message": self.message,
            "suggestion": self.suggestion,
        }


# ---------------------------------------------------------------------------
# Suppression
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Suppression:
    line: int                       # 1-based
    rule_ids: Tuple[str, ...]
    justified: bool


def parse_suppressions(source: str) -> Dict[int, Suppression]:
    """Per-line ``# repro: ignore[...]`` waivers in ``source``."""
    out: Dict[int, Suppression] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = IGNORE_RE.search(text)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        just = re.sub(r"^[\s\-—:]+", "", m.group(2))
        out[i] = Suppression(i, rules,
                             len(just.strip()) >= _MIN_JUSTIFICATION)
    return out


def apply_suppressions(findings: List[Finding], source: str,
                       path: str) -> List[Finding]:
    """Drop findings waived by justified ignore comments in ``source``;
    emit an ``analysis-suppression`` warning for every unjustified
    waiver (which suppresses nothing)."""
    supp = parse_suppressions(source)
    kept: List[Finding] = []
    for f in findings:
        s = supp.get(f.location.line) if f.location.file == path else None
        if s is not None and f.rule_id in s.rule_ids and s.justified:
            continue
        kept.append(f)
    for s in supp.values():
        if not s.justified:
            kept.append(Finding(
                "analysis-suppression", "warning",
                Location(file=path, line=s.line),
                f"ignore[{','.join(s.rule_ids)}] without a justification "
                f"— the waiver is inactive",
                "append the reason after the bracket: "
                "# repro: ignore[rule-id] -- why this is safe"))
    return kept


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------
BASELINE_VERSION = 1


def gate_counts(findings: List["Finding"]) -> Dict[str, int]:
    """Per-rule counts of the severities that gate an exit code
    (error + warning; info never gates)."""
    out: Dict[str, int] = {}
    for f in findings:
        if f.severity in ("error", "warning"):
            out[f.rule_id] = out.get(f.rule_id, 0) + 1
    return dict(sorted(out.items()))


def load_baseline(path: str) -> Dict[str, int]:
    """Rule -> gating-count map from a baseline file (or, tolerated,
    a full ``report.json`` — its findings are re-counted)."""
    with open(path) as f:
        data = json.load(f)
    if "gate_counts" in data:
        return {str(k): int(v) for k, v in data["gate_counts"].items()}
    out: Dict[str, int] = {}
    for rec in data.get("findings", []):
        if rec.get("severity") in ("error", "warning"):
            out[rec["rule_id"]] = out.get(rec["rule_id"], 0) + 1
    return dict(sorted(out.items()))


def baseline_regressions(current: Dict[str, int],
                         baseline: Dict[str, int]) -> List[str]:
    """Rules whose gating-finding count grew past the baseline — the
    only thing a baseline-diffed run fails on. Counts at or below the
    baseline (including rules that vanished) pass: the gate is
    ratchet-shaped, never absolute."""
    return [f"{rule}: {baseline.get(rule, 0)} -> {n}"
            for rule, n in sorted(current.items())
            if n > baseline.get(rule, 0)]


# ---------------------------------------------------------------------------
# Report
# ---------------------------------------------------------------------------
REPORT_VERSION = 1


@dataclass
class Report:
    """One analysis run: per-pass stats + the merged finding list."""

    preset: str
    rules: Optional[List[str]] = None
    findings: List[Finding] = field(default_factory=list)
    passes: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            out[f.severity] += 1
        return out

    def by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule_id] = out.get(f.rule_id, 0) + 1
        return dict(sorted(out.items()))

    def ok(self, strict: bool = False) -> bool:
        c = self.counts()
        return c["error"] == 0 and (not strict or c["warning"] == 0)

    def exit_code(self, strict: bool = False) -> int:
        return 0 if self.ok(strict) else 1

    def to_json(self) -> Dict[str, Any]:
        return {
            "version": REPORT_VERSION,
            "preset": self.preset,
            "rules": self.rules,
            "generated_unix": time.time(),
            "passes": self.passes,
            "counts": self.counts(),
            "by_rule": self.by_rule(),
            "pass": self.ok(),
            "strict_pass": self.ok(strict=True),
            "findings": [f.to_json() for f in self.findings],
        }

    def write(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        return path

    def baseline_json(self) -> Dict[str, Any]:
        """The committed-baseline form: rule -> gating counts only (no
        timestamps, no messages — diffs stay reviewable)."""
        return {
            "version": BASELINE_VERSION,
            "preset": self.preset,
            "gate_counts": gate_counts(self.findings),
        }

    def write_baseline(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.baseline_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path
