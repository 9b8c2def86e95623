"""Paradigm 1 — layer-based pipeline architecture (DNNBuilder [2]).

Implements the paper's Eq. 1 (throughput), Eq. 2 (stage latency),
Algorithm 1 (computation resource allocation: proportional, floored to
power-of-2, then greedy doubling of the most-loaded stage) and
Algorithm 2 (bandwidth allocation with the column-based cache scheme:
caching one more input column amortizes one more weight fetch, trading
BRAM for DRAM bandwidth).

Latency uses ceil-based cycle counts — the deterministic dedicated
datapath the paper credits for its 1.15% model error.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from repro_torch.core.hardware import FPGASpec
from repro_torch.core.workload import ConvLayer, Workload, as_conv_layers


# Logic-overhead model: every dedicated pipeline stage instantiates its
# own control FSM, DMA engines and line-buffer addressing (~14k LUTs),
# plus ~90 LUTs per MAC lane. This is the resource that limits paradigm-1
# scalability on deep DNNs (paper §5.1 / Fig. 7b): more stages =>
# less logic left to spend on parallelism.
LUT_PER_STAGE = 14_000
LUT_PER_PF = 90


def _pow2_floor(x: float) -> int:
    return 1 if x < 1 else 2 ** int(math.floor(math.log2(x)))


def _pow2_ceil(x: float) -> int:
    return 1 if x <= 1 else 2 ** int(math.ceil(math.log2(x)))


@dataclass
class StageConfig:
    layer: ConvLayer
    cpf: int = 1
    kpf: int = 1
    col: int = 1            # cached input columns (column-based cache)
    bw_bytes: float = 0.0   # allocated DRAM bandwidth

    @property
    def pf(self) -> int:
        return self.cpf * self.kpf

    @property
    def ei(self) -> int:
        """Input-parallel extent. Wide layers unroll over channels
        (power-of-2-friendly); thin-input stems (cin < 16) fold the
        r*s kernel window in (DNNBuilder's stem trick)."""
        l = self.layer
        return l.cin if l.cin >= 16 else l.r * l.s * l.cin

    @property
    def spatial_mult(self) -> int:
        l = self.layer
        return l.r * l.s if l.cin >= 16 else 1

    def compute_cycles(self) -> float:
        """Eq. 2 numerator with ceil-quantized tiling."""
        l = self.layer
        return (l.h_out * l.w_out * self.spatial_mult
                * math.ceil(self.ei / self.cpf)
                * math.ceil(l.cout / self.kpf))

    def compute_latency(self, freq_hz: float) -> float:
        return self.compute_cycles() / freq_hz

    def weight_stream_bytes_per_image(self, wbits: int) -> float:
        """Weights re-fetched once per cached-column group (DNNBuilder
        column cache). FC layers (w_out == 1) fetch weights once."""
        l = self.layer
        groups = math.ceil(l.w_out / self.col)
        return l.weight_bytes(wbits) * groups

    def memory_latency(self, wbits: int, batch: int = 1) -> float:
        """Weight-streaming time per *batch*: processing a column group
        batch-major reuses the fetched weight tile across all images of
        the batch (DNNBuilder batch amortization)."""
        if self.bw_bytes <= 0:
            return float("inf")
        return self.weight_stream_bytes_per_image(wbits) / self.bw_bytes

    def latency(self, freq_hz: float, wbits: int, batch: int = 1) -> float:
        """Stage latency for one batch = max(compute, weight streaming) —
        the two overlap via ping-pong weight buffers."""
        return max(batch * self.compute_latency(freq_hz),
                   self.memory_latency(wbits, batch))

    def input_buffer_bytes(self, abits: int, batch: int = 1) -> float:
        """Dual-port column cache, ping-pong (x2); batch-major processing
        caches the group columns of every image in the batch."""
        l = self.layer
        return 2.0 * batch * self.col * l.h * l.cin * abits / 8.0

    def weight_buffer_bytes(self, wbits: int) -> float:
        """Ping-pong weight tile: CPF x KPF x R x S coefficients."""
        l = self.layer
        return 2.0 * self.cpf * self.kpf * l.r * l.s * wbits / 8.0


@dataclass
class PipelineDesign:
    stages: List[StageConfig]
    freq_hz: float
    wbits: int
    abits: int
    batch: int = 1
    feasible: bool = True
    note: str = ""

    @property
    def dsp_used(self) -> int:
        return sum(s.pf for s in self.stages)      # scaled by macs/dsp later

    def stage_latencies(self, batch: Optional[int] = None) -> List[float]:
        b = self.batch if batch is None else batch
        return [s.latency(self.freq_hz, self.wbits, b) for s in self.stages]

    def image_latency(self) -> float:
        """Initial latency ~ sum of stage latencies (fine-grained pipeline
        overlaps at column granularity; steady-state is what we report)."""
        return sum(self.stage_latencies())

    def throughput_imgs(self, batch: Optional[int] = None) -> float:
        """Eq. 1: Batch / max(L_i) — L_i is the per-batch stage latency."""
        b = self.batch if batch is None else batch
        bottleneck = max(self.stage_latencies(b))
        return b / bottleneck

    def gops(self, batch: Optional[int] = None) -> float:
        ops = sum(s.layer.ops for s in self.stages)
        return ops * self.throughput_imgs(batch) / 1e9

    def bram_bytes(self) -> float:
        return sum(s.input_buffer_bytes(self.abits, self.batch)
                   + s.weight_buffer_bytes(self.wbits) for s in self.stages)


def allocate_compute(
    layers: Sequence[ConvLayer],
    pf_total: int,
) -> List[StageConfig]:
    """Algorithm 1. pf_total = DSP budget x MACs/DSP/cycle."""
    layers = as_conv_layers(layers)
    c = [l.macs for l in layers]
    c_total = float(sum(c))
    stages = [StageConfig(l) for l in layers]

    def par_cap(l: ConvLayer) -> int:
        ei = l.cin if l.cin >= 16 else l.r * l.s * l.cin
        return _pow2_floor(ei * l.cout)

    # lines 2-4: proportional, floored to power of two
    alloc = []
    for ci, l in zip(c, layers):
        r = max(1, _pow2_floor(ci / c_total * pf_total))
        r = min(r, par_cap(l))       # can't exceed layer parallelism
        alloc.append(r)
    # lines 5-9: greedy doubling of max C_j / R_j
    while True:
        used = sum(alloc)
        order = sorted(range(len(alloc)),
                       key=lambda j: c[j] / alloc[j], reverse=True)
        doubled = False
        for j in order:
            if alloc[j] < par_cap(layers[j]) \
                    and used + alloc[j] <= pf_total:
                alloc[j] *= 2
                doubled = True
                break
        if not doubled:
            break
    # line 10: R_i = CPF_i x KPF_i (CPF over the input-parallel extent)
    for st, r in zip(stages, alloc):
        l = st.layer
        cpf = min(_pow2_floor(max(1, st.ei)), r)
        kpf = max(1, r // cpf)
        kmax = _pow2_ceil(l.cout)
        if kpf > kmax:                                # rebalance overflow
            kpf = kmax
            cpf = max(1, r // kpf)
        st.cpf, st.kpf = cpf, kpf
    # fine-tune (paper: "fills up the gap between the actual and the
    # theoretical values"): CPF stays a power-of-2 vector width, but the
    # PE *count* KPF may take any integer. Binary-search the smallest
    # balanced bottleneck latency T for which the total PE budget still
    # suffices, then set every stage to the minimal KPF meeting T.
    def kpf_for_target(st: StageConfig, t_cycles: float) -> Optional[int]:
        l = st.layer
        base = (l.h_out * l.w_out * st.spatial_mult
                * math.ceil(st.ei / st.cpf))
        if t_cycles < base:          # even KPF = cout can't reach T
            return None
        groups = int(t_cycles // base)
        return max(1, min(l.cout, math.ceil(l.cout / groups)))

    def budget_for_target(t_cycles: float) -> Optional[int]:
        tot = 0
        for st in stages:
            k = kpf_for_target(st, t_cycles)
            if k is None:
                return None
            tot += st.cpf * k
        return tot

    hi_t = max(st.compute_cycles() for st in stages)
    lo_t = max(
        st.layer.h_out * st.layer.w_out * st.spatial_mult
        * math.ceil(st.ei / st.cpf)
        for st in stages
    )
    for _ in range(48):
        mid = 0.5 * (lo_t + hi_t)
        b = budget_for_target(mid)
        if b is not None and b <= pf_total:
            hi_t = mid
        else:
            lo_t = mid
    for st in stages:
        k = kpf_for_target(st, hi_t)
        if k is not None:
            st.kpf = k
    return stages


def allocate_bandwidth(
    stages: List[StageConfig],
    spec: FPGASpec,
    wbits: int,
    abits: int,
    bw_budget: Optional[float] = None,
    mem_budget: Optional[float] = None,
    batch: int = 1,
) -> bool:
    """Algorithm 2: satisfy per-stage weight-stream bandwidth; if the sum
    exceeds BW_total, grow the column cache (Col_i += 1) of the hungriest
    CONV stage while the input-buffer memory budget allows.

    Returns True if the final design fits within BW_total.
    """
    bw_total = spec.bw_bytes if bw_budget is None else bw_budget
    mem_total = spec.bram_bytes if mem_budget is None else mem_budget
    freq = spec.freq_hz

    def demand(st: StageConfig) -> float:
        # bandwidth needed so weight streaming never stalls compute
        # (weight tiles are reused across the batch: batch-major order)
        t = batch * st.compute_latency(freq)
        return st.weight_stream_bytes_per_image(wbits) / t

    # line 5: initial per-stage demand
    for st in stages:
        st.bw_bytes = demand(st)

    def mem_used() -> float:
        return sum(st.input_buffer_bytes(abits, batch)
                   + st.weight_buffer_bytes(wbits) for st in stages)

    # lines 6-13: column-cache growth loop
    while sum(st.bw_bytes for st in stages) > bw_total:
        conv = [st for st in stages if st.layer.w_out > st.col]
        if not conv:
            break
        st = max(conv, key=lambda s: s.bw_bytes)
        st.col += 1
        if mem_used() > mem_total:
            st.col -= 1
            break
        st.bw_bytes = demand(st)

    total = sum(st.bw_bytes for st in stages)
    if total > bw_total:
        # bandwidth-bound: scale every stage's share proportionally
        scale = bw_total / total
        for st in stages:
            st.bw_bytes *= scale
        return False
    return True


def pipeline_performance(
    layers: Sequence[ConvLayer],
    spec: FPGASpec,
    batch: int = 1,
    wbits: int = 16,
    abits: int = 16,
    dsp_budget: Optional[int] = None,
    bram_budget: Optional[float] = None,
    bw_budget: Optional[float] = None,
    lut_budget: Optional[float] = None,
) -> PipelineDesign:
    """Full paradigm-1 optimization + evaluation.

    ``layers`` may be a :class:`~repro_torch.core.workload.Workload` (CNN
    front-end) or a legacy ConvLayer sequence.
    """
    layers = as_conv_layers(layers)
    dsp = spec.dsp if dsp_budget is None else dsp_budget
    lut = spec.lut if lut_budget is None else lut_budget
    pf_total = int(dsp * spec.macs_per_dsp(wbits))
    pf_by_lut = int((lut - len(layers) * LUT_PER_STAGE) / LUT_PER_PF)
    pf_total = min(pf_total, max(0, pf_by_lut))
    if pf_total < len(layers):
        design = PipelineDesign([StageConfig(l) for l in layers],
                                spec.freq_hz, wbits, abits, batch,
                                feasible=False,
                                note="fewer PF units than stages")
        return design
    stages = allocate_compute(layers, pf_total)
    ok = allocate_bandwidth(stages, spec, wbits, abits,
                            bw_budget=bw_budget, mem_budget=bram_budget,
                            batch=batch)
    if not ok:
        # Bandwidth-bound: right-size compute so no allocated DSP idles
        # (DNNBuilder-style balanced design — this is why Fig. 8 keeps
        # paradigm-1 DSP *efficiency* high even when absolute GOP/s is
        # memory-capped at small inputs).
        target = max(st.latency(spec.freq_hz, wbits, batch) for st in stages)
        for st in stages:
            while st.kpf > 1 and batch * (st.compute_cycles() * st.kpf
                                  / (st.kpf - 1)) / spec.freq_hz <= target:
                st.kpf -= 1
            while st.cpf > 1:
                st.cpf //= 2
                if batch * st.compute_latency(spec.freq_hz) > target:
                    st.cpf *= 2
                    break
    return PipelineDesign(stages, spec.freq_hz, wbits, abits, batch,
                          feasible=True,
                          note="" if ok else "bandwidth-bound")


def pipeline_dsp_used(design: PipelineDesign, spec: FPGASpec) -> float:
    return sum(s.pf for s in design.stages) / spec.macs_per_dsp(design.wbits)


class PipelineModel:
    """Paradigm 1 behind the shared :class:`AcceleratorModel` protocol.

    Knobs: ``batch``. Everything else is resolved internally by
    Algorithms 1+2 — the level-2 optimization runs inside ``evaluate``.
    Consumes the :class:`Workload` IR (CNN front-end); bare ConvLayer
    sequences are coerced for back-compat.
    """

    name = "pipeline"

    def __init__(self, workload, spec: FPGASpec,
                 wbits: int = 16, abits: int = 16):
        self.workload = Workload.coerce(workload)
        self.layers = self.workload.conv_layers()
        self.spec = spec
        self.wbits = wbits
        self.abits = abits

    def evaluate(self, point) -> "EvalResult":
        from repro_torch.core.analytical.interface import EvalResult

        batch = max(1, int(point.get("batch", 1)))
        d = pipeline_performance(self.layers, self.spec, batch,
                                 self.wbits, self.abits)
        if not d.feasible:
            return EvalResult.infeasible(d.note or "pipeline infeasible",
                                         detail=d)
        thr = d.throughput_imgs(batch)
        return EvalResult(
            gops=d.gops(batch),
            throughput=thr,
            latency_s=batch / thr if thr > 0 else float("inf"),
            efficiency=pipeline_dsp_efficiency(d, self.spec, batch),
            resources={"dsp": pipeline_dsp_used(d, self.spec),
                       "bram_bytes": d.bram_bytes(),
                       "bw_bytes": sum(s.bw_bytes for s in d.stages)},
            detail=d)


def pipeline_dsp_efficiency(design: PipelineDesign, spec: FPGASpec,
                            batch: int = 1) -> float:
    """Eq. 11 with DSP_allocated."""
    alpha = 2.0 * spec.macs_per_dsp(design.wbits)
    dsp_alloc = pipeline_dsp_used(design, spec)
    if dsp_alloc == 0:
        return 0.0
    return design.gops(batch) * 1e9 / (alpha * dsp_alloc * spec.freq_hz)
