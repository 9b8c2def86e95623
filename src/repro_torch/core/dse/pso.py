"""Algorithm 4 — particle swarm optimization over RAVs.

Generic box-constrained PSO with integer snapping, exactly the paper's
update rule: V_i = w*V_i + c1*rand()*V_toLbest + c2*rand()*V_toGbest.
Deterministic under a fixed seed. Snapping is vectorized over the whole
swarm (one clip + masked round per iteration instead of a Python loop
per particle).

This module is the bare optimizer; the strategy-pluggable search layer
(memo cache, Pareto tracking, alternative strategies) lives in
``repro_torch.core.dse.search``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np


@dataclass
class PSOResult:
    best_position: np.ndarray
    best_fitness: float
    history: List[float]              # global best per iteration (Fig. 11 red curve)
    position_history: List[np.ndarray]  # global best position per iteration
    evaluations: int = 0              # fitness calls (cache may dedup below)


def snap_positions(pos: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                   integer: np.ndarray) -> np.ndarray:
    """Vectorized clip + integer rounding for (dim,) or (n, dim)."""
    pos = np.clip(pos, lo, hi)
    if integer.any():
        pos[..., integer] = np.round(pos[..., integer])
    return pos


def particle_swarm(
    fitness: Callable[[np.ndarray], float],
    lo: Sequence[float],
    hi: Sequence[float],
    integer: Sequence[bool],
    n_particles: int = 20,
    n_iters: int = 20,
    w: float = 0.6,
    c1: float = 1.6,
    c2: float = 1.6,
    seed: int = 0,
    seed_points: Optional[Sequence[Sequence[float]]] = None,
) -> PSOResult:
    """``seed_points``: known-good positions (e.g. the pure-paradigm
    corners SP=0 / SP=n) injected into the initial swarm, guaranteeing
    the hybrid search never loses to designs it strictly contains."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(lo, dtype=float)
    hi = np.asarray(hi, dtype=float)
    dim = lo.size
    integer = np.asarray(integer, dtype=bool)

    pos = rng.uniform(lo, hi, size=(n_particles, dim))
    if seed_points is not None:
        for i, sp in enumerate(seed_points[:n_particles]):
            pos[i] = np.asarray(sp, dtype=float)
    pos = snap_positions(pos, lo, hi, integer)
    vel = rng.uniform(-0.25, 0.25, size=(n_particles, dim)) * (hi - lo)

    fit = np.array([fitness(p) for p in pos])
    evals = n_particles
    lbest_pos = pos.copy()
    lbest_fit = fit.copy()
    g_idx = int(np.argmax(fit))
    gbest_pos, gbest_fit = pos[g_idx].copy(), float(fit[g_idx])

    history = [gbest_fit]
    pos_history = [gbest_pos.copy()]

    for _ in range(n_iters):
        r1 = rng.random((n_particles, dim))
        r2 = rng.random((n_particles, dim))
        vel = (w * vel
               + c1 * r1 * (lbest_pos - pos)
               + c2 * r2 * (gbest_pos[None, :] - pos))
        vmax = 0.5 * (hi - lo)
        vel = np.clip(vel, -vmax, vmax)
        pos = snap_positions(pos + vel, lo, hi, integer)
        fit = np.array([fitness(p) for p in pos])
        evals += n_particles
        improved = fit > lbest_fit
        lbest_pos[improved] = pos[improved]
        lbest_fit[improved] = fit[improved]
        g_idx = int(np.argmax(lbest_fit))
        if lbest_fit[g_idx] > gbest_fit:
            gbest_fit = float(lbest_fit[g_idx])
            gbest_pos = lbest_pos[g_idx].copy()
        history.append(gbest_fit)
        pos_history.append(gbest_pos.copy())

    return PSOResult(gbest_pos, gbest_fit, history, pos_history, evals)
