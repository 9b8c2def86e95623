"""Shared evaluation vocabulary for every analytical accelerator model.

The paper evaluates very different analytical models (the FPGA
layer-pipeline, paradigm 1; the generic reusable array, paradigm 2; the
hybrid of both, paradigm 3) inside the *same* two-level DSE loop, and
the port adds its one-card model (``gpu_model``) to them. This module is the contract that makes
that possible:

* :class:`DesignPoint` — one decoded candidate (named knob values, the
  RAV of Algorithm 4);
* :class:`EvalResult` — what every model reports back: GOP/s,
  throughput, latency, a utilization-style efficiency (DSP efficiency
  on FPGAs, roofline fraction on the card), per-resource usage, and a
  feasibility verdict with a reason (the paper's resource-budget
  constraints);
* :class:`AcceleratorModel` — the protocol the search core drives:
  ``evaluate(DesignPoint) -> EvalResult``.

The DSE core (``repro_torch.core.dse``) only ever sees this interface, so new
accelerator domains plug in by writing one adapter class.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple

from typing import Protocol, runtime_checkable


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

    ``efficiency`` is the domain's utilization measure: DSP efficiency
    (Eq. 11) for the FPGA models, roofline fraction (useful FLOP/s over
    peak) for the one-card model and the measured model. ``resources`` holds per-resource usage in
    native units (``dsp``, ``bram_bytes``, ``bw_bytes`` / ``hbm_bytes``
    ...). ``detail`` carries the domain design object (PipelineDesign,
    HybridDesign, GPUAnalysis, ...) for reporting code that needs it.
    """

    gops: float = 0.0              # absolute compute rate, GOP/s
    throughput: float = 0.0        # domain rate: images/s or steps/s
    latency_s: float = float("inf")
    efficiency: float = 0.0        # DSP eff. (FPGA) | roofline frac (card)
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


@runtime_checkable
class AcceleratorModel(Protocol):
    """Anything the DSE search core can drive.

    Implementations: ``PipelineModel``, ``GenericModel``,
    ``HybridModel`` (FPGA domain), ``GPUModel`` (one card) and
    ``MeasuredModel``.
    """

    name: str

    def evaluate(self, point: DesignPoint) -> EvalResult:
        """Score one design point; must never raise on out-of-budget
        inputs — return ``EvalResult.infeasible(reason)`` instead."""
        ...
