"""Two-level DSE over one card's plans: the reference's TPU engine
(``repro.core.dse.tpu_engine``) at one chip, over the shared search core.

Level 1: a pluggable strategy (default PSO, Algorithm 4) over
``[log2 M, quant]``. The reference's ``sp``, ``front_is`` and
``tail_is`` change nothing on one chip, so they are not dimensions here
(the reference collapses such dims itself). Level 2: inside
:meth:`GPUModel.evaluate` the plan is scored with
:func:`repro_torch.core.analytical.gpu_model.analyze`; infeasible plans
(HBM overflow, indivisible microbatching, int8 training) score zero.

Fitness = useful model FLOP/s over the card's peak (roofline fraction);
the search also reports the (throughput, latency, efficiency,
logit_dev) frontier.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.analytical.gpu_model import (
    GPUAnalysis,
    GPUModel,
    GPUPlan,
    analyze,
)
from repro_torch.core.dse.pareto import PRECISION_OBJECTIVES, ParetoFront
from repro_torch.core.dse.search import (SearchResult, SearchStrategy,
                                         run_search)
from repro_torch.core.dse.space import DesignSpace, Dimension
from repro_torch.core.hardware import H100_SXM, GPUSpec


def gpu_design_space() -> DesignSpace:
    """The 7 x 2 one-card space: no knob depends on the model, so the
    reference's layer split (``tpu_design_space(cfg)``) has no
    counterpart."""
    return DesignSpace.of([
        Dimension("log2_m", 0, 6, integer=True),
        # 0 = bf16 storage, 1 = int8 weights + KV (charged logit_dev)
        Dimension("quant", 0, 1, integer=True),
    ])


@dataclass
class GPUExploreResult:
    best_plan: GPUPlan
    best_analysis: GPUAnalysis
    best_fitness: float            # roofline fraction
    search: SearchResult

    @property
    def pareto(self) -> ParetoFront:
        return self.search.pareto


def explore_gpu(cfg: ModelConfig, shape: ShapeConfig,
                n_particles: int = 16, n_iters: int = 16, seed: int = 0,
                chip: GPUSpec = H100_SXM,
                strategy: Union[str, SearchStrategy] = "pso",
                workload=None,
                ) -> GPUExploreResult:
    """Search one card's plans for one (arch x shape) cell, scored on the
    analytic LM profile of ``cfg`` at ``shape``.

    ``workload`` overrides the op profile the model scores — pass a
    traced :class:`~repro_torch.core.workload.Workload`
    (``trace_workload(cfg, shape)``) to explore against the port's
    executed ops instead of the analytic LM profile.
    """
    model = GPUModel(cfg, shape, chip=chip, workload=workload)
    space = gpu_design_space()
    # the reference's warm-start microbatch ladder, in both precisions
    seeds = [space.from_dict(dict(log2_m=m, quant=q))
             for m in (0, 3, 6) for q in (0, 1)]
    res = run_search(
        model, space, strategy=strategy,
        objective=lambda r: r.efficiency, seed=seed,
        seed_points=seeds,
        objectives=PRECISION_OBJECTIVES,
        n_particles=n_particles, n_iters=n_iters,
        population=n_particles, generations=n_iters)
    best_plan = model.plan_for(res.best_point)
    best_ana = res.best_result.detail
    if not isinstance(best_ana, GPUAnalysis):
        # best point infeasible (a shape one card cannot hold): analyze
        # anyway so callers always get roofline terms to report
        best_ana = analyze(model.workload, best_plan, chip=chip)
    return GPUExploreResult(
        best_plan=best_plan,
        best_analysis=best_ana,
        best_fitness=res.best_fitness,
        search=res)
