"""Paradigm 3 — the paper's novel hybrid architecture (§5.2).

Layers 1..SP run on a dedicated layer-wise pipeline with resource budget
[DSP_p, BRAM_p, BW_p]; layers SP+1..n run on a generic reusable array
with the remaining budget. Both share batch size and clock. Steady-state
throughput is the min of the two sections' rates (they operate
concurrently on a stream of inputs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.core.analytical.generic import (
    GenericDesign,
    generic_dse,
    generic_dsp_used,
)
from repro_torch.core.analytical.pipeline import (
    PipelineDesign,
    pipeline_dsp_used,
    pipeline_performance,
)
from repro_torch.core.hardware import FPGASpec
from repro_torch.core.workload import ConvLayer, Workload, as_conv_layers


@dataclass
class HybridDesign:
    sp: int
    batch: int
    pipeline: Optional[PipelineDesign]
    generic: Optional[GenericDesign]
    spec: FPGASpec
    wbits: int
    abits: int
    feasible: bool = True

    def throughput_imgs(self) -> float:
        rates = []
        if self.pipeline is not None and self.pipeline.stages:
            if not self.pipeline.feasible:
                return 0.0
            rates.append(self.pipeline.throughput_imgs(self.batch))
        if self.generic is not None and self.generic.dataflows:
            if not self.generic.feasible:
                return 0.0
            rates.append(self.generic.throughput_imgs(self.batch))
        return min(rates) if rates else 0.0

    def total_ops(self) -> int:
        ops = 0
        if self.pipeline is not None:
            ops += sum(s.layer.ops for s in self.pipeline.stages)
        if self.generic is not None:
            ops += sum(l.ops for l in self.generic.layers)
        return ops

    def gops(self) -> float:
        return self.total_ops() * self.throughput_imgs() / 1e9

    def dsp_used(self) -> float:
        used = 0.0
        if self.pipeline is not None:
            used += pipeline_dsp_used(self.pipeline, self.spec)
        if self.generic is not None and self.generic.dataflows:
            used += generic_dsp_used(self.generic, self.spec)
        return used

    def dsp_efficiency(self) -> float:
        alpha = 2.0 * self.spec.macs_per_dsp(self.wbits)
        dsp = self.dsp_used()
        if dsp == 0:
            return 0.0
        return self.gops() * 1e9 / (alpha * dsp * self.spec.freq_hz)

    def bram_used(self) -> float:
        used = 0.0
        if self.pipeline is not None:
            used += self.pipeline.bram_bytes()
        if self.generic is not None and self.generic.dataflows:
            hw = self.generic.hw
            used += hw.cap_fbuf + hw.cap_wbuf + hw.cap_abuf
        return used


def hybrid_performance(
    layers: Sequence[ConvLayer],
    spec: FPGASpec,
    sp: int,
    batch: int = 1,
    dsp_p: Optional[int] = None,
    bram_p: Optional[float] = None,
    bw_p: Optional[float] = None,
    wbits: int = 16,
    abits: int = 16,
) -> HybridDesign:
    """Evaluate one RAV = [SP, Batch, DSP_p, BRAM_p, BW_p] (level-2 of the
    DSE runs inside: Algs 1+2 for the front, Alg 3 for the tail).

    ``layers`` may be a :class:`Workload` (CNN front-end) or a legacy
    ConvLayer sequence.
    """
    layers = as_conv_layers(layers)
    sp = max(0, min(sp, len(layers)))
    front, tail = layers[:sp], layers[sp:]
    if dsp_p is None:
        dsp_p = int(spec.dsp * (sum(l.macs for l in front)
                                / max(1, sum(l.macs for l in layers))))
    if bram_p is None:
        bram_p = spec.bram_bytes * sp / max(1, len(layers))
    if bw_p is None:
        bw_p = spec.bw_bytes * 0.5

    dsp_p = max(0, min(dsp_p, spec.dsp))
    bram_p = max(0.0, min(bram_p, spec.bram_bytes))
    bw_p = max(0.0, min(bw_p, spec.bw_bytes))

    lut_p = spec.lut * (dsp_p / max(1, spec.dsp))
    pipe = None
    if front:
        pipe = pipeline_performance(
            front, spec, batch, wbits, abits,
            dsp_budget=dsp_p, bram_budget=bram_p, bw_budget=bw_p,
            lut_budget=lut_p)
    gen = None
    if tail:
        gen = generic_dse(
            tail, spec, batch, wbits, abits,
            dsp_budget=spec.dsp - (dsp_p if front else 0),
            bram_budget=spec.bram_bytes - (bram_p if front else 0.0),
            bw_budget=spec.bw_bytes - (bw_p if front else 0.0),
            lut_budget=spec.lut - (lut_p if front else 0.0))
    feasible = ((pipe is None or pipe.feasible)
                and (gen is None or gen.feasible))
    return HybridDesign(sp, batch, pipe, gen, spec, wbits, abits, feasible)


class HybridModel:
    """Paradigm 3 behind the shared :class:`AcceleratorModel` protocol.

    Knobs = the paper's RAV: ``sp``, ``batch``, ``dsp_p``, ``bram_p``,
    ``bw_p`` (Table 1). ``evaluate`` runs the full level-2 optimization
    (Algs 1+2 for the pipeline front, Alg 3 for the generic tail) —
    this is the fitness function of the two-level DSE.
    """

    name = "hybrid"

    def __init__(self, workload, spec: FPGASpec,
                 wbits: int = 16, abits: int = 16):
        self.workload = Workload.coerce(workload)
        self.layers = self.workload.conv_layers()
        self.spec = spec
        self.wbits = wbits
        self.abits = abits

    def evaluate(self, point) -> "EvalResult":
        from repro_torch.core.analytical.interface import EvalResult

        dsp_p = point.get("dsp_p")
        d = hybrid_performance(
            self.layers, self.spec,
            sp=int(point["sp"]),
            batch=max(1, int(point.get("batch", 1))),
            dsp_p=int(dsp_p) if dsp_p is not None else None,
            bram_p=point.get("bram_p"),
            bw_p=point.get("bw_p"),
            wbits=self.wbits, abits=self.abits)
        if not d.feasible:
            why = []
            if d.pipeline is not None and not d.pipeline.feasible:
                why.append(f"pipeline: {d.pipeline.note}")
            if d.generic is not None and not d.generic.feasible:
                why.append("generic: no hardware point fits budget")
            return EvalResult.infeasible("; ".join(why) or "infeasible",
                                         detail=d)
        thr = d.throughput_imgs()
        return EvalResult(
            gops=d.gops(),
            throughput=thr,
            latency_s=d.batch / thr if thr > 0 else float("inf"),
            efficiency=d.dsp_efficiency(),
            resources={"dsp": d.dsp_used(),
                       "bram_bytes": d.bram_used()},
            detail=d)
