"""Token sampling for the serving engine.

One frozen :class:`Sampler` policy serves the whole engine; randomness
is drawn from *per-request* streams (seeded by ``(sampler.seed, rid)``)
so a request's tokens are reproducible regardless of batch composition,
admission order, or which slot it landed in. Both the admission
(prefill logits) and the decode step route through :meth:`sample` — the
seed engine's ``greedy=False`` branch hard-coded token 0 instead.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

SAMPLER_KINDS = ("greedy", "temperature")


@dataclass(frozen=True)
class Sampler:
    """Sampling policy: ``greedy`` (argmax) or ``temperature`` softmax
    sampling with an optional top-k filter.

    ``top_k=0`` means the full vocabulary; ``seed`` roots every
    per-request stream (see :meth:`stream`).
    """

    kind: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if self.kind not in SAMPLER_KINDS:
            raise ValueError(
                f"unknown sampler kind {self.kind!r}; "
                f"available: {SAMPLER_KINDS}")
        if self.kind == "temperature" and not self.temperature > 0:
            raise ValueError(
                f"temperature must be > 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")

    # ------------------------------------------------------------------
    def stream(self, rid: int) -> np.random.Generator:
        """The request's private RNG stream. Deterministic in
        ``(seed, rid)`` only — slot assignment and neighbours in the
        batch cannot perturb it. Negative rids are mapped into the
        uint64 seed space (SeedSequence rejects them raw)."""
        return np.random.default_rng(
            (int(self.seed) & (2 ** 64 - 1), int(rid) & (2 ** 64 - 1)))

    def sample(self, logits: np.ndarray,
               rng: Optional[np.random.Generator] = None) -> int:
        """One token id from a (V,) logit row."""
        logits = np.asarray(logits, np.float64).reshape(-1)
        if self.kind == "greedy":
            return int(np.argmax(logits))
        if rng is None:
            raise ValueError("temperature sampling needs the request's "
                             "rng stream (Sampler.stream(rid))")
        z = logits / self.temperature
        if self.top_k and self.top_k < z.shape[0]:
            kth = np.partition(z, -self.top_k)[-self.top_k]
            z = np.where(z >= kth, z, -np.inf)
        z = z - z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(rng.choice(p.shape[0], p=p))
