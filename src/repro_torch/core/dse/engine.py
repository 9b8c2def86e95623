"""Two-level DSE — FPGA domain, as a thin adapter over the shared
search core (paper §5.3).

Level 1: a pluggable strategy (default: PSO, Algorithm 4) over the
RAV = [SP, Batch, DSP_p, BRAM_p, BW_p] described as a
:class:`DesignSpace`. Level 2: inside :class:`HybridModel.evaluate`,
Algorithms 1+2 configure the pipeline section and Algorithm 3 the
generic section. Fitness = analytic throughput (GOP/s); the search also
reports the (throughput, latency, efficiency) Pareto frontier and the
memo-cache accounting.

The one-card twin (`repro_torch.core.dse.gpu_engine`) adapts the same core
to microbatch and precision plans.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np

from repro_torch.core.analytical.generic import GenericModel
from repro_torch.core.analytical.hybrid import HybridDesign, HybridModel
from repro_torch.core.analytical.interface import DesignPoint, EvalResult
from repro_torch.core.analytical.pipeline import PipelineModel
from repro_torch.core.dse.pareto import ParetoFront
from repro_torch.core.dse.search import SearchResult, SearchStrategy, run_search
from repro_torch.core.dse.space import DesignSpace, Dimension
from repro_torch.core.hardware import FPGASpec
from repro_torch.core.workload import ConvLayer, Workload, as_conv_layers


def fpga_design_space(workload, spec: FPGASpec,
                      batch: Optional[int] = None,
                      max_batch: int = 32) -> DesignSpace:
    """Table-1 design space. A fixed batch becomes a degenerate
    (lo == hi) dimension, so every strategy honors it for free."""
    n = len(as_conv_layers(workload))
    b_lo, b_hi = (batch, batch) if batch is not None else (1, max_batch)
    # Partition knobs are lattice-quantized: DSP in column-group
    # slices, BRAM in 16-block groups, bandwidth in 1/64 shares.
    # Physically honest (placement granularity is far coarser than a
    # single DSP/byte) — the level-2 allocators re-flow whatever the
    # partition gives them — and the lattice is what makes the memo
    # cache bite once the swarm converges.
    return DesignSpace.of([
        Dimension("sp", 0, n, integer=True),
        Dimension("batch", b_lo, b_hi, integer=True),
        Dimension("dsp_p", 0, spec.dsp, integer=True),
        Dimension("bram_p", 0.0, spec.bram_bytes, step=36 * 1024 / 8),
        Dimension("bw_p", 0.05 * spec.bw_bytes, 0.95 * spec.bw_bytes,
                  step=spec.bw_bytes / 512),
    ])


def _corner_seeds(space: DesignSpace, layers, spec,
                  fixed_batch: Optional[int],
                  max_batch: int) -> List[np.ndarray]:
    """Pure-paradigm corner points (SP=n pipeline-only, SP=0
    generic-only) at a few batch sizes: the warm start that guarantees
    the hybrid search never loses to designs it strictly contains."""
    n = len(layers)
    b0 = fixed_batch if fixed_batch is not None else 1
    corners = [
        dict(sp=n, batch=b0, dsp_p=spec.dsp,
             bram_p=0.7 * spec.bram_bytes, bw_p=0.9 * spec.bw_bytes),
        dict(sp=0, batch=b0, dsp_p=0, bram_p=0.0,
             bw_p=0.05 * spec.bw_bytes),
        dict(sp=n // 2, batch=b0, dsp_p=spec.dsp // 2,
             bram_p=0.5 * spec.bram_bytes, bw_p=0.5 * spec.bw_bytes),
    ]
    if fixed_batch is None:
        corners += [
            dict(sp=n, batch=max_batch, dsp_p=spec.dsp,
                 bram_p=0.7 * spec.bram_bytes, bw_p=0.9 * spec.bw_bytes),
            dict(sp=0, batch=max_batch, dsp_p=0, bram_p=0.0,
                 bw_p=0.05 * spec.bw_bytes),
        ]
    return [space.from_dict(c) for c in corners]


@dataclass
class FPGAExploreResult:
    best_design: HybridDesign
    search: SearchResult
    spec: FPGASpec
    # Fig. 11 traces
    batch_trace: List[int]
    sp_trace: List[int]
    gops_trace: List[float]

    @property
    def pareto(self) -> ParetoFront:
        return self.search.pareto

    @property
    def best_result(self) -> EvalResult:
        return self.search.best_result

    @property
    def feasible(self) -> bool:
        """False when no evaluated point (not even the warm-start
        corners) fit the device — ``best_design`` then reports 0
        GOP/s; check this before quoting its numbers."""
        return self.search.best_result.feasible


def explore_fpga(
    workload,
    spec: FPGASpec,
    batch: Optional[int] = None,
    max_batch: int = 32,
    wbits: int = 16,
    abits: int = 16,
    n_particles: int = 20,
    n_iters: int = 20,
    fix_batch: bool = False,
    seed: int = 0,
    strategy: Union[str, SearchStrategy] = "pso",
) -> FPGAExploreResult:
    """Level-1 search over the RAV (Algorithm 4 + Table 1 space).

    ``workload`` is a CNN-frontend :class:`Workload` (legacy ConvLayer
    sequences are coerced).
    """
    wl = Workload.coerce(workload)
    layers = wl.conv_layers()
    fixed = batch if (fix_batch and batch is not None) else None
    space = fpga_design_space(wl, spec, fixed, max_batch)
    model = HybridModel(wl, spec, wbits, abits)
    res = run_search(
        model, space, strategy=strategy,
        objective=lambda r: r.gops, seed=seed,
        seed_points=_corner_seeds(space, layers, spec, fixed, max_batch),
        n_particles=n_particles, n_iters=n_iters,
        population=n_particles, generations=n_iters)

    i_sp = space.names.index("sp")
    i_b = space.names.index("batch")
    return FPGAExploreResult(
        best_design=res.best_result.detail,
        search=res,
        spec=spec,
        batch_trace=[int(p[i_b]) for p in res.position_history],
        sp_trace=[int(p[i_sp]) for p in res.position_history],
        gops_trace=list(res.history))


def benchmark_paradigm(
    workload,
    spec: FPGASpec,
    paradigm: int,
    batch: Optional[int] = None,
    wbits: int = 16,
    abits: int = 16,
    sp: Optional[int] = None,
    seed: int = 0,
) -> EvalResult:
    """Benchmark one paradigm after its respective optimization
    (paper §4), through the shared :class:`AcceleratorModel` interface.

    ``batch=None`` evaluates paradigms 1/2 at batch 1 and lets the
    paradigm-3 search explore the batch dimension (this used to be
    impossible: the old ``fix_batch=batch is not None`` with a default
    of 1 pinned the batch always).
    """
    wl = Workload.coerce(workload)
    if paradigm == 1:
        model = PipelineModel(wl, spec, wbits, abits)
        return model.evaluate(DesignPoint.make(batch=batch or 1))
    if paradigm == 2:
        model = GenericModel(wl, spec, wbits, abits)
        return model.evaluate(DesignPoint.make(batch=batch or 1))
    if paradigm == 3:
        res = explore_fpga(wl, spec, batch=batch, wbits=wbits,
                           abits=abits, n_iters=12, n_particles=12,
                           fix_batch=batch is not None, seed=seed)
        return res.best_result
    raise ValueError(f"paradigm must be 1|2|3, got {paradigm}")
