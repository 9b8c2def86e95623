"""Shared evaluation vocabulary of the accelerator models.

The port's copy of ``DesignPoint`` and ``EvalResult`` from the
reference's ``repro.core.analytical.interface``: one decoded design
candidate, and what every model reports back (GOP/s, throughput,
latency, efficiency, resources, a feasibility verdict with a reason).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple


@dataclass(frozen=True)
class DesignPoint:
    """One decoded design candidate: ordered (knob, value) pairs.

    Frozen + hashable so it can key memo caches and Pareto archives.
    """

    knobs: Tuple[Tuple[str, float], ...]

    @classmethod
    def make(cls, mapping: Mapping[str, float] = (), **kw: float
             ) -> "DesignPoint":
        items = list(dict(mapping, **kw).items())
        return cls(tuple((str(k), float(v)) for k, v in items))

    def as_dict(self) -> Dict[str, float]:
        return dict(self.knobs)

    def __getitem__(self, name: str) -> float:
        for k, v in self.knobs:
            if k == name:
                return v
        raise KeyError(name)

    def get(self, name: str, default: Optional[float] = None
            ) -> Optional[float]:
        for k, v in self.knobs:
            if k == name:
                return v
        return default

    def __repr__(self) -> str:  # compact, log-friendly
        inner = ", ".join(f"{k}={v:g}" for k, v in self.knobs)
        return f"DesignPoint({inner})"


@dataclass
class EvalResult:
    """Uniform score card one analytical evaluation produces.

    ``efficiency`` is the domain's utilization measure: for the measured
    model, useful FLOP/s over the card's peak. ``resources`` holds
    per-resource usage in native units; ``detail`` carries per-op rows
    for reporting code that needs them.
    """

    gops: float = 0.0              # absolute compute rate, GOP/s
    throughput: float = 0.0        # domain rate: images/s or steps/s
    latency_s: float = float("inf")
    efficiency: float = 0.0        # useful FLOP/s over peak
    feasible: bool = True
    reason: str = ""               # why infeasible (empty when feasible)
    resources: Dict[str, float] = field(default_factory=dict)
    detail: Any = None

    @classmethod
    def infeasible(cls, reason: str, detail: Any = None) -> "EvalResult":
        return cls(feasible=False, reason=reason, detail=detail)

    def objectives(self) -> Tuple[float, float, float]:
        """(throughput, latency_s, efficiency) — the multi-objective
        tuple the Pareto frontier tracks."""
        return (self.throughput, self.latency_s, self.efficiency)
