"""Pareto-frontier tracking over (throughput, latency, efficiency).

The paper's DSE reports one scalar best (GOP/s); QUIDAM-style
co-exploration shows the *frontier* is the useful output — a deployer
picks the latency-optimal point for real-time workloads and the
throughput-optimal one for batch serving from the same search. The
front is maintained online during search (every unique evaluation is
offered to it), so it costs no extra analytical evaluations.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.analytical.interface import DesignPoint, EvalResult


@dataclass(frozen=True)
class Objective:
    name: str
    maximize: bool
    extract: Callable[[EvalResult], float]

    def canonical(self, r: EvalResult) -> float:
        """Maximize-form value (negated for minimize objectives)."""
        v = self.extract(r)
        return v if self.maximize else -v


DEFAULT_OBJECTIVES: Tuple[Objective, ...] = (
    Objective("throughput", True, lambda r: r.throughput),
    Objective("latency_s", False, lambda r: r.latency_s),
    Objective("efficiency", True, lambda r: r.efficiency),
)

#: The precision-aware frontier: DEFAULT_OBJECTIVES plus the accuracy
#: proxy quantized candidates are charged — max abs logit deviation vs
#: the bf16 reference (``EvalResult.resources['logit_dev']``; 0.0 for
#: full-precision points, so bf16 candidates are never accuracy-
#: dominated and a quantized point must win on speed to join the front).
PRECISION_OBJECTIVES: Tuple[Objective, ...] = DEFAULT_OBJECTIVES + (
    Objective("logit_dev", False,
              lambda r: r.resources.get("logit_dev", 0.0)),
)


@dataclass(frozen=True)
class ParetoEntry:
    point: DesignPoint
    result: EvalResult
    canonical: Tuple[float, ...]    # maximize-form objective vector

    def objective_values(self, objectives: Sequence[Objective]
                         ) -> Dict[str, float]:
        return {o.name: o.extract(self.result) for o in objectives}


def _dominates(a: Tuple[float, ...], b: Tuple[float, ...]) -> bool:
    """a dominates b: >= everywhere, > somewhere (maximize-form)."""
    ge = all(x >= y for x, y in zip(a, b))
    gt = any(x > y for x, y in zip(a, b))
    return ge and gt


class ParetoFront:
    """Online nondominated archive. ``update`` is O(front size) per
    offered point — negligible next to one analytical evaluation."""

    def __init__(self, objectives: Sequence[Objective]
                 = DEFAULT_OBJECTIVES):
        self.objectives = tuple(objectives)
        self.entries: List[ParetoEntry] = []

    def update(self, point: DesignPoint, result: EvalResult) -> bool:
        """Offer one evaluated point; returns True iff it joined the
        front (possibly evicting dominated members)."""
        if not result.feasible:
            return False
        cand = tuple(o.canonical(result) for o in self.objectives)
        for e in self.entries:
            if _dominates(e.canonical, cand) or e.canonical == cand:
                return False
        self.entries = [e for e in self.entries
                        if not _dominates(cand, e.canonical)]
        self.entries.append(ParetoEntry(point, result, cand))
        return True

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self):
        return iter(self.entries)

    def best_by(self, name: str) -> Optional[ParetoEntry]:
        """Frontier member optimal in one named objective."""
        idx = {o.name: i for i, o in enumerate(self.objectives)}[name]
        if not self.entries:
            return None
        return max(self.entries, key=lambda e: e.canonical[idx])

    def table(self) -> List[Dict[str, float]]:
        """Rows for reporting: knobs + objective values."""
        rows = []
        for e in sorted(self.entries, key=lambda e: -e.canonical[0]):
            row = dict(e.point.knobs)
            row.update(e.objective_values(self.objectives))
            rows.append(row)
        return rows
