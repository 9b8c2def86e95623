"""Declarative traffic scenarios shared by the static analyzer and the
measured serving path.

A verbatim copy of the reference's ``repro.serve.scenarios``; only
this docstring names the port's modules.

A :class:`Scenario` is a small, dependency-free record of *what traffic
looks like*: an arrival process (mean rate, burstiness), discrete
prompt- and output-length distributions, and SLO targets. The same
record is

* linted statically by ``repro_torch.analysis.deploy_lint`` (scheduler
  liveness + M/G/1-style queueing bounds, no execution), and
* accepted by ``python -m repro_torch.launch.serve --scenario <name>``,
  which samples its requests from it, so the static lower bounds and
  the measured percentiles come from one spec.

Length distributions are finite weighted support sets — every moment
and quantile is closed-form and deterministic, which is what keeps
``deploy_preflight`` reproducible across processes (no RNG in the
bounds; RNG only in :meth:`Scenario.sample_requests` for replay).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Tuple

__all__ = [
    "LengthDist", "ArrivalSpec", "SLOSpec", "Scenario",
    "SCENARIOS", "get_scenario",
]


@dataclass(frozen=True)
class LengthDist:
    """Discrete length distribution: ``((length, weight), ...)``."""

    points: Tuple[Tuple[int, float], ...]

    def __post_init__(self):
        if not self.points:
            raise ValueError("LengthDist needs at least one support point")
        pts = tuple(sorted((int(l), float(w)) for l, w in self.points))
        for l, w in pts:
            if l < 1:
                raise ValueError(f"length {l} < 1")
            if w <= 0:
                raise ValueError(f"weight {w} <= 0 for length {l}")
        object.__setattr__(self, "points", pts)

    @property
    def support(self) -> Tuple[int, ...]:
        return tuple(l for l, _ in self.points)

    @property
    def weights(self) -> Tuple[float, ...]:
        total = sum(w for _, w in self.points)
        return tuple(w / total for _, w in self.points)

    @property
    def min(self) -> int:
        return self.points[0][0]

    @property
    def max(self) -> int:
        return self.points[-1][0]

    @property
    def mean(self) -> float:
        return sum(l * w for l, w in zip(self.support, self.weights))

    def quantile(self, q: float) -> int:
        """Smallest support length whose CDF reaches ``q``."""
        acc = 0.0
        for l, w in zip(self.support, self.weights):
            acc += w
            if acc >= q - 1e-12:
                return l
        return self.max

    def expect(self, fn) -> float:
        """E[fn(length)] over the support."""
        return sum(fn(l) * w for l, w in zip(self.support, self.weights))

    def scaled(self, factor: float) -> "LengthDist":
        """Shrink lengths by ``factor`` (<=1), merging collided points."""
        merged: Dict[int, float] = {}
        for l, w in self.points:
            nl = max(1, int(l * factor))
            merged[nl] = merged.get(nl, 0.0) + w
        return LengthDist(tuple(sorted(merged.items())))


@dataclass(frozen=True)
class ArrivalSpec:
    """Open-loop arrival process.

    ``rate_rps`` is the long-run mean; ``peak_factor`` scales it at the
    worst moment of the process (burst interior / diurnal peak), which
    is what the near-saturation lint checks against.
    """

    rate_rps: float
    process: str = "poisson"          # poisson | burst | diurnal
    peak_factor: float = 1.0
    burst_size: int = 8               # requests per burst (process=burst)

    def __post_init__(self):
        if self.rate_rps <= 0:
            raise ValueError("rate_rps must be > 0")
        if self.process not in ("poisson", "burst", "diurnal"):
            raise ValueError(f"unknown arrival process {self.process!r}")
        if self.peak_factor < 1.0:
            raise ValueError("peak_factor must be >= 1")

    @property
    def peak_rps(self) -> float:
        return self.rate_rps * self.peak_factor

    def interarrivals(self, n: int, rng) -> List[float]:
        """Seconds between consecutive arrivals, deterministic in rng."""
        if self.process == "poisson":
            return list(rng.exponential(1.0 / self.rate_rps, n))
        if self.process == "burst":
            # bursts at peak_rps spacing, idle gap restores the mean rate
            gaps = []
            gap = max(0.0, self.burst_size / self.rate_rps
                      - self.burst_size / self.peak_rps)
            for i in range(n):
                ia = float(rng.exponential(1.0 / self.peak_rps))
                if i and i % self.burst_size == 0:
                    ia += gap
                gaps.append(ia)
            return gaps
        # diurnal: sinusoidal rate between rate and peak over the trace
        import math
        gaps = []
        for i in range(n):
            phase = math.sin(math.pi * i / max(1, n - 1)) ** 2
            rate = self.rate_rps * (1.0 + (self.peak_factor - 1.0) * phase)
            gaps.append(float(rng.exponential(1.0 / rate)))
        return gaps


@dataclass(frozen=True)
class SLOSpec:
    """Latency targets the deployment must meet (milliseconds)."""

    ttft_ms: float                    # time-to-first-token, p99
    tok_p50_ms: float                 # per-token decode latency, median
    tok_p99_ms: float

    def __post_init__(self):
        if min(self.ttft_ms, self.tok_p50_ms, self.tok_p99_ms) <= 0:
            raise ValueError("SLO targets must be > 0")
        if self.tok_p99_ms < self.tok_p50_ms:
            raise ValueError("tok_p99_ms < tok_p50_ms")


@dataclass(frozen=True)
class Scenario:
    """Named traffic scenario: arrivals x lengths x SLOs."""

    name: str
    description: str
    arrival: ArrivalSpec
    prompt_lens: LengthDist
    output_lens: LengthDist
    slo: SLOSpec

    def max_context(self) -> int:
        """Largest prompt+output context the scenario can demand."""
        return self.prompt_lens.max + self.output_lens.max

    def scaled(self, max_len: int) -> "Scenario":
        """Fit the scenario into ``max_len`` total context.

        Used to replay production-shaped traffic against smoke configs:
        lengths shrink proportionally, rates and SLOs are untouched.
        """
        ctx = self.max_context()
        if ctx <= max_len:
            return self
        factor = max_len / ctx
        return replace(self,
                       prompt_lens=self.prompt_lens.scaled(factor),
                       output_lens=self.output_lens.scaled(factor))

    def sample_requests(self, n: int, seed: int = 0):
        """Deterministic replay trace: (arrival_s, prompt_len, out_len).

        Arrival times are absolute seconds from trace start.
        """
        import numpy as np
        rng = np.random.default_rng(seed)
        gaps = self.arrival.interarrivals(n, rng)
        t, rows = 0.0, []
        plens = rng.choice(self.prompt_lens.support, size=n,
                           p=self.prompt_lens.weights)
        olens = rng.choice(self.output_lens.support, size=n,
                           p=self.output_lens.weights)
        for i in range(n):
            t += gaps[i]
            rows.append((t, int(plens[i]), int(olens[i])))
        return rows

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "description": self.description,
            "arrival": {
                "rate_rps": self.arrival.rate_rps,
                "process": self.arrival.process,
                "peak_factor": self.arrival.peak_factor,
                "burst_size": self.arrival.burst_size,
            },
            "prompt_lens": [list(p) for p in self.prompt_lens.points],
            "output_lens": [list(p) for p in self.output_lens.points],
            "slo": {
                "ttft_ms": self.slo.ttft_ms,
                "tok_p50_ms": self.slo.tok_p50_ms,
                "tok_p99_ms": self.slo.tok_p99_ms,
            },
        }

    @classmethod
    def from_json(cls, data: dict) -> "Scenario":
        return cls(
            name=data["name"],
            description=data.get("description", ""),
            arrival=ArrivalSpec(**data["arrival"]),
            prompt_lens=LengthDist(
                tuple((int(l), float(w)) for l, w in data["prompt_lens"])),
            output_lens=LengthDist(
                tuple((int(l), float(w)) for l, w in data["output_lens"])),
            slo=SLOSpec(**data["slo"]),
        )


def _scenario_library() -> Dict[str, Scenario]:
    chat_burst = Scenario(
        name="chat_burst",
        description="interactive chat; arrivals clump into 4x bursts, "
                    "mid prompts, mid outputs",
        arrival=ArrivalSpec(rate_rps=4.0, process="burst", peak_factor=4.0),
        prompt_lens=LengthDist(((32, 2.0), (96, 4.0), (192, 3.0),
                                (384, 1.0))),
        output_lens=LengthDist(((16, 2.0), (64, 5.0), (128, 3.0))),
        slo=SLOSpec(ttft_ms=1500.0, tok_p50_ms=40.0, tok_p99_ms=120.0),
    )
    rag = Scenario(
        name="rag_long_context",
        description="retrieval-augmented answers: long stuffed prompts, "
                    "short grounded outputs",
        arrival=ArrivalSpec(rate_rps=1.0, process="poisson"),
        prompt_lens=LengthDist(((1024, 2.0), (2048, 5.0), (3584, 3.0))),
        output_lens=LengthDist(((48, 4.0), (128, 5.0), (256, 1.0))),
        slo=SLOSpec(ttft_ms=6000.0, tok_p50_ms=60.0, tok_p99_ms=200.0),
    )
    code = Scenario(
        name="code_completion",
        description="IDE tab-completion: high rate, mid prompts, tiny "
                    "outputs, tight tail SLO",
        arrival=ArrivalSpec(rate_rps=16.0, process="poisson"),
        prompt_lens=LengthDist(((64, 3.0), (160, 5.0), (320, 2.0))),
        output_lens=LengthDist(((8, 6.0), (24, 3.0), (48, 1.0))),
        slo=SLOSpec(ttft_ms=600.0, tok_p50_ms=25.0, tok_p99_ms=80.0),
    )
    diurnal = Scenario(
        name="diurnal_open_loop",
        description="open-loop daily cycle: mean rate modest, 3x peak "
                    "at the top of the curve",
        arrival=ArrivalSpec(rate_rps=2.0, process="diurnal",
                            peak_factor=3.0),
        prompt_lens=LengthDist(((48, 3.0), (128, 5.0), (256, 2.0))),
        output_lens=LengthDist(((32, 3.0), (96, 5.0), (192, 2.0))),
        slo=SLOSpec(ttft_ms=2500.0, tok_p50_ms=50.0, tok_p99_ms=150.0),
    )
    return {s.name: s for s in (chat_burst, rag, code, diurnal)}


SCENARIOS: Dict[str, Scenario] = _scenario_library()


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}"
        ) from None
