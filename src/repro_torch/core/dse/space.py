"""Design-space descriptor (the paper's Table 1).

A :class:`DesignSpace` names each RAV dimension with its box bounds and
integrality, and provides the vectorized *snapping* (clip + integer
rounding) every search strategy shares. Because integer dimensions snap
to a lattice, swarm/population positions collide constantly — snapped
vectors are therefore the natural memo-cache key
(:meth:`DesignSpace.key`), which is what lets the cached evaluator cut
redundant analytical evaluations.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.analytical.interface import DesignPoint


@dataclass(frozen=True)
class Dimension:
    """One knob: name, inclusive box bounds, integrality, and an
    optional quantization ``step``.

    ``step`` snaps continuous dims to a lattice ``lo + k*step`` —
    resource-partition knobs (BRAM bytes, bandwidth shares) are
    physically granular anyway (BRAM blocks, AXI quanta), and a lattice
    is what makes the memo cache effective: a converged swarm piles
    onto a handful of lattice points instead of generating a fresh key
    per float."""

    name: str
    lo: float
    hi: float
    integer: bool = False
    step: Optional[float] = None

    def __post_init__(self):
        assert self.hi >= self.lo, (self.name, self.lo, self.hi)
        assert self.step is None or self.step > 0

    @property
    def fixed(self) -> bool:
        return self.hi == self.lo


@dataclass(frozen=True)
class DesignSpace:
    """Ordered collection of dimensions + vectorized decode helpers."""

    dims: Tuple[Dimension, ...]

    @classmethod
    def of(cls, dims: Iterable[Dimension]) -> "DesignSpace":
        return cls(tuple(dims))

    # ------------------------------------------------------------- views
    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(d.name for d in self.dims)

    @property
    def lo(self) -> np.ndarray:
        return np.array([d.lo for d in self.dims], dtype=float)

    @property
    def hi(self) -> np.ndarray:
        return np.array([d.hi for d in self.dims], dtype=float)

    @property
    def integer(self) -> np.ndarray:
        return np.array([d.integer for d in self.dims], dtype=bool)

    def __len__(self) -> int:
        return len(self.dims)

    # --------------------------------------------------------- operations
    def snap(self, pos: np.ndarray) -> np.ndarray:
        """Clip to the box, quantize stepped dims to their lattice,
        round integer dims. Vectorized: ``pos`` is ``(dim,)`` or
        ``(n, dim)``; returns a new array."""
        lo, hi = self.lo, self.hi
        pos = np.clip(np.asarray(pos, dtype=float), lo, hi)
        for i, d in enumerate(self.dims):
            if d.step is not None:
                pos[..., i] = d.lo + np.round(
                    (pos[..., i] - d.lo) / d.step) * d.step
        pos = np.clip(pos, lo, hi)
        mask = self.integer
        if mask.any():
            pos[..., mask] = np.round(pos[..., mask])
        return pos

    def key(self, snapped: np.ndarray) -> Tuple[float, ...]:
        """Hashable memo key for one *snapped* vector. Integer dims are
        cast to int so 3.0 and 3 collide; stepped dims use their
        lattice index; free continuous dims are rounded to 9
        significant digits to absorb float noise."""
        out = []
        for d, v in zip(self.dims, snapped):
            if d.integer:
                out.append(int(v))
            elif d.step is not None:
                out.append(int(round((v - d.lo) / d.step)))
            else:
                out.append(float(f"{v:.9g}"))
        return tuple(out)

    def to_point(self, snapped: np.ndarray) -> DesignPoint:
        return DesignPoint(tuple(
            (d.name, float(v)) for d, v in zip(self.dims, snapped)))

    def from_dict(self, values: Dict[str, float]) -> np.ndarray:
        """Vector for a named assignment (e.g. a warm-start corner)."""
        return self.snap(np.array([values[d.name] for d in self.dims],
                                  dtype=float))

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """(n, dim) uniform snapped samples."""
        return self.snap(rng.uniform(self.lo, self.hi,
                                     size=(n, len(self.dims))))
