"""The two-level DSE of the port (the port's copy of ``repro.core.dse``):
the design space, the Pareto front, PSO and the search core, the FPGA
explorer and its one-card counterpart of the TPU explorer."""
from repro_torch.core.dse.space import DesignSpace, Dimension
from repro_torch.core.dse.pareto import (
    DEFAULT_OBJECTIVES,
    Objective,
    ParetoFront,
)
from repro_torch.core.dse.search import (
    STRATEGIES,
    CachedEvaluator,
    EvolutionaryStrategy,
    PSOStrategy,
    RandomLocalRefineStrategy,
    SearchResult,
    SearchStrategy,
    run_search,
)
from repro_torch.core.dse.pso import PSOResult, particle_swarm
from repro_torch.core.dse.engine import (
    FPGAExploreResult,
    benchmark_paradigm,
    explore_fpga,
    fpga_design_space,
)
from repro_torch.core.dse.gpu_engine import (
    GPUExploreResult,
    explore_gpu,
    gpu_design_space,
)

__all__ = [
    "DesignSpace", "Dimension",
    "Objective", "ParetoFront", "DEFAULT_OBJECTIVES",
    "SearchStrategy", "PSOStrategy", "EvolutionaryStrategy",
    "RandomLocalRefineStrategy", "STRATEGIES",
    "CachedEvaluator", "SearchResult", "run_search",
    "PSOResult", "particle_swarm",
    "FPGAExploreResult", "explore_fpga", "fpga_design_space",
    "benchmark_paradigm",
    "GPUExploreResult", "explore_gpu", "gpu_design_space",
]
