"""Paradigm 2 — generic reusable architecture (HybridDNN [3]).

Implements the paper's Eqs. 3-10 (compute / weight / feature-map
latencies under IS and WS dataflows with ping-pong buffer grouping) and
Algorithm 3 (STEP1 enumerate hardware parameter choices under the
resource model; STEP2 pick the best dataflow per layer; STEP3 take the
global minimum-latency solution).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.hardware import FPGASpec
from repro_torch.core.workload import ConvLayer, Workload, as_conv_layers


@dataclass(frozen=True)
class GenericHWParams:
    cpf: int
    kpf: int
    # on-chip buffer capacities (bytes)
    cap_fbuf: float
    cap_wbuf: float
    cap_abuf: float
    # DRAM bandwidth split (bytes/s)
    bw_w: float
    bw_ifm: float
    bw_ofm: float


@dataclass
class GenericDesign:
    hw: GenericHWParams
    dataflows: List[str]
    layer_latencies: List[float]
    freq_hz: float
    wbits: int
    abits: int
    layers: Sequence[ConvLayer] = ()
    feasible: bool = True

    def total_latency(self, batch: int = 1) -> float:
        return sum(self.layer_latencies) * 1.0  # latencies already per-batch

    def throughput_imgs(self, batch: int = 1) -> float:
        lat = sum(self.layer_latencies)
        return batch / lat if lat > 0 else 0.0

    def gops(self, batch: int = 1) -> float:
        ops = sum(l.ops for l in self.layers)
        return ops * self.throughput_imgs(batch) / 1e9


def generic_layer_latency(
    layer: ConvLayer,
    hw: GenericHWParams,
    freq_hz: float,
    wbits: int,
    abits: int,
    batch: int = 1,
) -> Tuple[float, str]:
    """Eqs. 3-10 for one layer; returns (best latency for `batch` images,
    chosen dataflow)."""
    l = layer
    # Eq. 3 with ceil-quantized tiling (utilization-accurate)
    cycles = (l.h_out * l.w_out * l.r * l.s
              * math.ceil(l.cin / hw.cpf) * math.ceil(l.cout / hw.kpf))
    l_comp = cycles / freq_hz
    w_bytes = l.weight_bytes(wbits)
    ifm_bytes = l.in_bytes(abits)
    ofm_bytes = l.h_out * l.w_out * l.cout * abits / 8.0
    l_w = w_bytes / hw.bw_w                       # Eq. 4
    l_ifm = ifm_bytes / hw.bw_ifm                 # Eq. 5
    l_ofm = ofm_bytes / hw.bw_ofm                 # Eq. 6

    # IS: feature maps grouped by the accumulation buffer (Eq. 7);
    # weights re-fetched per group (Eq. 8). Batch multiplies fm traffic
    # and compute; weights re-fetched per image's groups.
    g_fm = max(1, math.ceil(ofm_bytes / (hw.cap_abuf / 2.0)))
    l_is = max(batch * l_comp, batch * g_fm * l_w,
               batch * l_ifm, batch * l_ofm)

    # WS: weights grouped by the weight buffer (Eq. 9); fmaps stream per
    # weight group (Eq. 10). Batch amortizes the weight fetches.
    g_w = max(1, math.ceil(w_bytes / (hw.cap_wbuf / 2.0)))
    l_ws = max(batch * l_comp, l_w,
               batch * g_w * l_ifm, batch * g_w * l_ofm)

    if l_is <= l_ws:
        return l_is, "IS"
    return l_ws, "WS"


# Algorithm 3 STEP1 resource model: DSPs for the MAC array, BRAM for the
# three buffers, LUTs for the (single) control path + MAC lanes.
LUT_FIXED = 30_000
LUT_PER_PF = 90


def _resource_model(cpf: int, kpf: int, spec: FPGASpec, wbits: int,
                    bram_frac: float) -> Tuple[float, float]:
    n_dsp = cpf * kpf / spec.macs_per_dsp(wbits)
    bram_bytes = bram_frac * spec.bram_bytes
    return n_dsp, bram_bytes


BUFFER_SPLITS = [
    (0.50, 0.30, 0.20),
    (0.30, 0.50, 0.20),
    (0.25, 0.25, 0.50),
    (0.40, 0.20, 0.40),
]
BW_SPLITS = [
    (0.60, 0.20, 0.20),
    (0.40, 0.30, 0.30),
    (0.20, 0.40, 0.40),
]


def generic_dse(
    layers: Sequence[ConvLayer],
    spec: FPGASpec,
    batch: int = 1,
    wbits: int = 16,
    abits: int = 16,
    dsp_budget: Optional[int] = None,
    bram_budget: Optional[float] = None,
    bw_budget: Optional[float] = None,
    lut_budget: Optional[float] = None,
) -> GenericDesign:
    """Algorithm 3 (all three STEPs), vectorized over the param lattice
    with numpy — the PSO fitness calls this hundreds of times.

    ``layers`` may be a :class:`Workload` (CNN front-end) or a legacy
    ConvLayer sequence.
    """
    import numpy as np

    layers = as_conv_layers(layers)
    dsp_total = spec.dsp if dsp_budget is None else dsp_budget
    bram_total = spec.bram_bytes if bram_budget is None else bram_budget
    bw_total = spec.bw_bytes if bw_budget is None else bw_budget
    lut_total = spec.lut if lut_budget is None else lut_budget

    # STEP1: enumerate hardware parameter choices
    hw_params: List[GenericHWParams] = []
    pf_budget = dsp_total * spec.macs_per_dsp(wbits)
    pf_budget = min(pf_budget, max(0.0, (lut_total - LUT_FIXED) / LUT_PER_PF))
    cpf = 2
    while cpf <= 512:
        kpf = 2
        while kpf <= 512:
            if cpf * kpf <= pf_budget:
                for (ff, wf, af) in BUFFER_SPLITS:
                    for (bw, bi, bo) in BW_SPLITS:
                        hw_params.append(GenericHWParams(
                            cpf, kpf,
                            cap_fbuf=ff * bram_total,
                            cap_wbuf=wf * bram_total,
                            cap_abuf=af * bram_total,
                            bw_w=bw * bw_total,
                            bw_ifm=bi * bw_total,
                            bw_ofm=bo * bw_total,
                        ))
            kpf *= 2
        cpf *= 2

    if not hw_params:
        return GenericDesign(
            GenericHWParams(1, 1, 1, 1, 1, bw_total, bw_total, bw_total),
            ["IS"] * len(layers), [float("inf")] * len(layers),
            spec.freq_hz, wbits, abits, layers=layers, feasible=False)

    # STEP2 vectorized: (P params) x (L layers) latency matrices
    P = len(hw_params)
    cpf_a = np.array([h.cpf for h in hw_params], float)[:, None]
    kpf_a = np.array([h.kpf for h in hw_params], float)[:, None]
    abuf = np.array([h.cap_abuf for h in hw_params], float)[:, None]
    wbuf = np.array([h.cap_wbuf for h in hw_params], float)[:, None]
    bww = np.array([h.bw_w for h in hw_params], float)[:, None]
    bwi = np.array([h.bw_ifm for h in hw_params], float)[:, None]
    bwo = np.array([h.bw_ofm for h in hw_params], float)[:, None]

    base = np.array([l.h_out * l.w_out * l.r * l.s for l in layers],
                    float)[None, :]
    cin = np.array([l.cin for l in layers], float)[None, :]
    cout = np.array([l.cout for l in layers], float)[None, :]
    wby = np.array([l.weight_bytes(wbits) for l in layers], float)[None, :]
    iby = np.array([l.in_bytes(abits) for l in layers], float)[None, :]
    oby = np.array([l.h_out * l.w_out * l.cout * abits / 8.0
                    for l in layers], float)[None, :]

    cycles = base * np.ceil(cin / cpf_a) * np.ceil(cout / kpf_a)
    l_comp = cycles / spec.freq_hz                      # Eq. 3
    l_w = wby / bww                                     # Eq. 4
    l_ifm = iby / bwi                                   # Eq. 5
    l_ofm = oby / bwo                                   # Eq. 6
    g_fm = np.maximum(1, np.ceil(oby / np.maximum(abuf / 2.0, 1.0)))  # Eq. 7
    l_is = np.maximum.reduce([batch * l_comp, batch * g_fm * l_w,
                              batch * l_ifm, batch * l_ofm])   # Eq. 8
    g_w = np.maximum(1, np.ceil(wby / np.maximum(wbuf / 2.0, 1.0)))   # Eq. 9
    l_ws = np.maximum.reduce([batch * l_comp, l_w,
                              batch * g_w * l_ifm,
                              batch * g_w * l_ofm])     # Eq. 10
    lat = np.minimum(l_is, l_ws)
    total = lat.sum(axis=1)

    # STEP3: global minimum
    idx = int(np.argmin(total))
    dataflows = ["IS" if l_is[idx, j] <= l_ws[idx, j] else "WS"
                 for j in range(len(layers))]
    return GenericDesign(hw_params[idx], dataflows, list(lat[idx]),
                         spec.freq_hz, wbits, abits, layers=layers)


def generic_performance(layers, spec, batch=1, wbits=16, abits=16,
                        **budgets) -> GenericDesign:
    return generic_dse(layers, spec, batch, wbits, abits, **budgets)


class GenericModel:
    """Paradigm 2 behind the shared :class:`AcceleratorModel` protocol.

    Knobs: ``batch``. Algorithm 3 (STEP1-3) runs inside ``evaluate``.
    Consumes the :class:`Workload` IR (CNN front-end); bare ConvLayer
    sequences are coerced for back-compat.
    """

    name = "generic"

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
        d = generic_dse(self.layers, self.spec, batch,
                        self.wbits, self.abits)
        if not d.feasible:
            return EvalResult.infeasible("no hardware point fits budget",
                                         detail=d)
        thr = d.throughput_imgs(batch)
        hw = d.hw
        return EvalResult(
            gops=d.gops(batch),
            throughput=thr,
            latency_s=batch / thr if thr > 0 else float("inf"),
            efficiency=generic_dsp_efficiency(d, self.spec, batch),
            resources={"dsp": generic_dsp_used(d, self.spec),
                       "bram_bytes": hw.cap_fbuf + hw.cap_wbuf
                       + hw.cap_abuf,
                       "bw_bytes": hw.bw_w + hw.bw_ifm + hw.bw_ofm},
            detail=d)


def generic_dsp_used(design: GenericDesign, spec: FPGASpec) -> float:
    return design.hw.cpf * design.hw.kpf / spec.macs_per_dsp(design.wbits)


def generic_dsp_efficiency(design: GenericDesign, spec: FPGASpec,
                           batch: int = 1) -> float:
    alpha = 2.0 * spec.macs_per_dsp(design.wbits)
    dsp_alloc = generic_dsp_used(design, spec)
    if dsp_alloc == 0:
        return 0.0
    return design.gops(batch) * 1e9 / (alpha * dsp_alloc * spec.freq_hz)
