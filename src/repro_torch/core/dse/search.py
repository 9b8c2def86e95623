"""Strategy-pluggable, memo-cached search core for the two-level DSE.

This is the engine room both explorers (`engine.explore_fpga`,
`gpu_engine.explore_gpu`) share:

* :class:`CachedEvaluator` wraps any :class:`AcceleratorModel` behind a
  scalar fitness function with a memo cache keyed on *snapped* RAVs.
  Integer dimensions make swarm positions collide constantly, so a
  plain dict cuts a large fraction of redundant analytical
  evaluations; every unique evaluation is also offered to the running
  (throughput, latency, efficiency) Pareto frontier for free.
* :class:`SearchStrategy` implementations drive the fitness function:
  the paper's PSO (Algorithm 4), a (mu+lambda) evolutionary strategy,
  and random sampling + coordinate local refinement.
* :func:`run_search` wires model + space + strategy together and
  returns one uniform :class:`SearchResult`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.analytical.interface import (
    AcceleratorModel,
    DesignPoint,
    EvalResult,
)
from repro_torch.core.dse.pareto import DEFAULT_OBJECTIVES, Objective, ParetoFront
from repro_torch.core.dse.pso import particle_swarm, snap_positions
from repro_torch.core.dse.space import DesignSpace

Fitness = Callable[[np.ndarray], float]


# ---------------------------------------------------------------------------
# Cached evaluator
# ---------------------------------------------------------------------------
class CachedEvaluator:
    """Scalar fitness over a model, memoized on snapped positions.

    Infeasible points score 0.0 (all objectives here are nonnegative
    rates), matching the paper's "resource-budget constraints score
    zero" convention.
    """

    def __init__(self, model: AcceleratorModel, space: DesignSpace,
                 objective: Optional[Callable[[EvalResult], float]] = None,
                 objectives: Sequence[Objective] = DEFAULT_OBJECTIVES):
        self.model = model
        self.space = space
        self.objective = objective or (lambda r: r.gops)
        self.pareto = ParetoFront(objectives)
        self._cache: Dict[Tuple, float] = {}
        self.calls = 0
        self.cache_hits = 0
        self.best_fitness = float("-inf")
        self.best_vector: Optional[np.ndarray] = None
        self.best_point: Optional[DesignPoint] = None
        self.best_result: Optional[EvalResult] = None

    @property
    def unique_evaluations(self) -> int:
        return len(self._cache)

    def __call__(self, pos: np.ndarray) -> float:
        self.calls += 1
        snapped = self.space.snap(np.asarray(pos, dtype=float))
        key = self.space.key(snapped)
        cached = self._cache.get(key)
        if cached is not None:
            self.cache_hits += 1
            return cached
        point = self.space.to_point(snapped)
        result = self.model.evaluate(point)
        fit = self.objective(result) if result.feasible else 0.0
        self._cache[key] = fit
        self.pareto.update(point, result)
        if fit > self.best_fitness or self.best_result is None:
            self.best_fitness = fit
            self.best_vector = snapped
            self.best_point = point
            self.best_result = result
        return fit


# ---------------------------------------------------------------------------
# Result
# ---------------------------------------------------------------------------
@dataclass
class SearchResult:
    """Uniform output of every strategy."""

    best_vector: np.ndarray
    best_point: DesignPoint
    best_result: EvalResult
    best_fitness: float
    history: List[float]                    # best-so-far per iteration
    position_history: List[np.ndarray]      # best vector per iteration
    pareto: ParetoFront
    strategy: str = "pso"
    calls: int = 0                          # fitness invocations
    unique_evaluations: int = 0             # analytical model runs
    cache_hits: int = 0

    @property
    def cache_hit_rate(self) -> float:
        return self.cache_hits / self.calls if self.calls else 0.0


# ---------------------------------------------------------------------------
# Strategies
# ---------------------------------------------------------------------------
class SearchStrategy:
    """Drives a fitness function over a DesignSpace. Subclasses return
    (history, position_history) of the best-so-far trajectory; best
    tracking and caching live in :class:`CachedEvaluator`."""

    name = "base"

    def run(self, fitness: Fitness, space: DesignSpace, seed: int,
            seed_points: Optional[Sequence[np.ndarray]] = None,
            ) -> Tuple[List[float], List[np.ndarray]]:
        raise NotImplementedError


def coordinate_refine(fitness: Fitness, space: DesignSpace,
                      start: np.ndarray, start_fit: float,
                      budget: int) -> Tuple[np.ndarray, float, int]:
    """Accelerated coordinate descent around an incumbent on the
    snapped lattice: per dimension, step both directions and keep
    doubling the step while it improves (Alg-1-style greedy doubling);
    after two fully-stalled sweeps try one coarser scale, then stop.
    Spends at most ``budget`` fitness evaluations. Returns
    ``(best, best_fit, spent)``. Shared by the PSO refinement tail and
    the random+local-refine strategy."""
    best = space.snap(np.asarray(start, dtype=float).copy())
    best_fit = start_fit
    span = space.hi - space.lo
    spent = 0
    scale = 1.0
    stalled = 0
    while spent < budget and stalled < 2:
        any_move = False
        for i, d in enumerate(space.dims):
            if spent >= budget:
                break
            if span[i] == 0:
                continue
            delta = d.step if d.step is not None else (
                1.0 if d.integer else span[i] / 64.0)
            delta *= scale
            if d.integer:
                delta = max(1.0, round(delta))
            for sign in (1.0, -1.0):
                moved = False
                step = delta
                while spent < budget:
                    cand = best.copy()
                    cand[i] += sign * step
                    f = fitness(cand)
                    spent += 1
                    if f > best_fit:
                        best_fit = f
                        best = space.snap(cand)
                        moved = True
                        step *= 2.0
                    else:
                        break
                if moved:
                    any_move = True
                    break
        if any_move:
            stalled = 0
        else:
            stalled += 1
            scale *= 4.0   # one coarser escape sweep, then stop
    return best, best_fit, spent


class PSOStrategy(SearchStrategy):
    """The paper's Algorithm 4 (level-1 of the two-level DSE), plus a
    budgeted lattice local-refinement tail.

    With ``refine=True`` (default) the last two nominal iterations'
    evaluation budget is spent on coordinate descent around the swarm
    best instead of two more swarm sweeps: PSO has converged by then
    (Fig. 11 converges within ~10 of 20 iterations) while single-knob
    polish still finds lattice neighbors the swarm jumped over. The
    refinement spends at most ``2*n_particles - 1`` evaluations, so the
    whole strategy performs *strictly fewer* fitness evaluations than
    the classic ``n_particles * (n_iters + 1)`` schedule — and through
    the memo cache, re-visited neighbors cost nothing at all.
    """

    name = "pso"

    def __init__(self, n_particles: int = 20, n_iters: int = 20,
                 w: float = 0.6, c1: float = 1.6, c2: float = 1.6,
                 refine: bool = True):
        self.n_particles = n_particles
        self.n_iters = n_iters
        self.w, self.c1, self.c2 = w, c1, c2
        self.refine = refine

    def run(self, fitness, space, seed, seed_points=None):
        do_refine = self.refine and self.n_iters >= 4
        pso_iters = self.n_iters - (2 if do_refine else 0)
        budget = (2 * self.n_particles - 1) if do_refine else 0

        res = particle_swarm(
            fitness, space.lo, space.hi, space.integer,
            n_particles=self.n_particles, n_iters=pso_iters,
            w=self.w, c1=self.c1, c2=self.c2, seed=seed,
            seed_points=seed_points)
        history = list(res.history)
        position_history = list(res.position_history)
        if not do_refine:
            return history, position_history

        best, best_fit, _ = coordinate_refine(
            fitness, space, res.best_position, res.best_fitness, budget)
        # pad the trace back to n_iters+1 entries so Fig.-11 style
        # convergence plots keep their x-axis
        history += [best_fit] * 2
        position_history += [best.copy()] * 2
        return history, position_history


class EvolutionaryStrategy(SearchStrategy):
    """(mu+lambda) evolutionary search: tournament selection, blend
    crossover, gaussian mutation with decaying sigma, elitism. Useful
    where PSO's momentum stalls on discrete plateaus."""

    name = "evolutionary"

    def __init__(self, population: int = 20, generations: int = 20,
                 tournament: int = 3, mutation_scale: float = 0.25,
                 elite: int = 2):
        self.population = population
        self.generations = generations
        self.tournament = tournament
        self.mutation_scale = mutation_scale
        self.elite = elite

    def run(self, fitness, space, seed, seed_points=None):
        rng = np.random.default_rng(seed)
        lo, hi, integer = space.lo, space.hi, space.integer
        span = hi - lo
        pop = space.sample(rng, self.population)
        if seed_points is not None:
            for i, sp in enumerate(list(seed_points)[:self.population]):
                pop[i] = space.snap(np.asarray(sp, dtype=float))
        fit = np.array([fitness(p) for p in pop])

        history: List[float] = [float(fit.max())]
        position_history = [pop[int(np.argmax(fit))].copy()]

        def pick() -> np.ndarray:
            idx = rng.integers(0, len(pop), size=self.tournament)
            return pop[idx[np.argmax(fit[idx])]]

        for gen in range(self.generations):
            sigma = self.mutation_scale * span \
                * (1.0 - 0.8 * gen / max(1, self.generations))
            children = []
            for _ in range(self.population):
                a, b = pick(), pick()
                alpha = rng.random(len(space))
                child = alpha * a + (1.0 - alpha) * b
                mut = rng.random(len(space)) < 0.5
                child = child + mut * rng.normal(0.0, 1.0,
                                                 len(space)) * sigma
                children.append(child)
            children = snap_positions(np.array(children), lo, hi, integer)
            child_fit = np.array([fitness(c) for c in children])
            # (mu+lambda) elitist survival
            allpop = np.concatenate([pop, children])
            allfit = np.concatenate([fit, child_fit])
            order = np.argsort(-allfit)[:self.population]
            pop, fit = allpop[order], allfit[order]
            history.append(float(fit[0]))
            position_history.append(pop[0].copy())
        return history, position_history


class RandomLocalRefineStrategy(SearchStrategy):
    """Uniform random sampling followed by coordinate-descent local
    refinement around the incumbent (:func:`coordinate_refine`).
    A strong cheap baseline — and a sanity check on the fancier
    strategies (if PSO loses to this, the space is degenerate).

    Accepts the common ``n_particles`` / ``n_iters`` budget vocabulary
    so callers that size a search for PSO spend a comparable number of
    evaluations here: ``n_random = n_particles * n_iters`` and a
    refinement budget of ``n_particles - 1`` (one eval short of the
    classic ``n_particles * (n_iters + 1)`` schedule)."""

    name = "random-refine"

    def __init__(self, n_random: Optional[int] = None,
                 refine_budget: Optional[int] = None,
                 n_particles: Optional[int] = None,
                 n_iters: Optional[int] = None):
        if n_random is None:
            n_random = (n_particles * n_iters
                        if n_particles and n_iters else 128)
        if refine_budget is None:
            refine_budget = (n_particles - 1) if n_particles else 64
        self.n_random = n_random
        self.refine_budget = refine_budget

    def run(self, fitness, space, seed, seed_points=None):
        rng = np.random.default_rng(seed)
        cands = space.sample(rng, self.n_random)
        if seed_points is not None:
            cands = np.concatenate(
                [space.snap(np.asarray(list(seed_points), dtype=float)
                            .reshape(-1, len(space))), cands])
        fits = np.array([fitness(c) for c in cands])
        best = cands[int(np.argmax(fits))].copy()
        best_fit = float(fits.max())
        history = [best_fit]
        position_history = [best.copy()]

        best, best_fit, _ = coordinate_refine(
            fitness, space, best, best_fit, self.refine_budget)
        history.append(best_fit)
        position_history.append(best.copy())
        return history, position_history


STRATEGIES: Dict[str, Callable[[], SearchStrategy]] = {
    "pso": PSOStrategy,
    "evolutionary": EvolutionaryStrategy,
    "random-refine": RandomLocalRefineStrategy,
}


def make_strategy(strategy: Union[str, SearchStrategy, None],
                  **defaults) -> SearchStrategy:
    """Resolve a strategy name/instance; kwargs only apply to names."""
    if isinstance(strategy, SearchStrategy):
        return strategy
    if strategy is None:
        strategy = "pso"
    try:
        cls = STRATEGIES[strategy]
    except KeyError:
        raise ValueError(
            f"unknown strategy {strategy!r}; "
            f"available: {sorted(STRATEGIES)}") from None
    import inspect
    accepted = inspect.signature(cls).parameters
    return cls(**{k: v for k, v in defaults.items() if k in accepted})


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------
def run_search(model: AcceleratorModel, space: DesignSpace,
               strategy: Union[str, SearchStrategy, None] = "pso",
               objective: Optional[Callable[[EvalResult], float]] = None,
               objectives: Sequence[Objective] = DEFAULT_OBJECTIVES,
               seed: int = 0,
               seed_points: Optional[Sequence[np.ndarray]] = None,
               **strategy_kwargs) -> SearchResult:
    """Search ``space`` for the ``objective``-best design of ``model``.

    The returned result carries the scalar winner, the full best-so-far
    trace (Fig. 11), the multi-objective Pareto frontier, and the cache
    accounting (``unique_evaluations`` < ``calls`` whenever snapping
    made candidates collide).
    """
    strat = make_strategy(strategy, **strategy_kwargs)
    ev = CachedEvaluator(model, space, objective, objectives)
    history, position_history = strat.run(ev, space, seed, seed_points)
    assert ev.best_result is not None, "strategy evaluated nothing"
    return SearchResult(
        best_vector=ev.best_vector,
        best_point=ev.best_point,
        best_result=ev.best_result,
        best_fitness=ev.best_fitness,
        history=history,
        position_history=position_history,
        pareto=ev.pareto,
        strategy=strat.name,
        calls=ev.calls,
        unique_evaluations=ev.unique_evaluations,
        cache_hits=ev.cache_hits)
