"""Cycle-approximate discrete-event simulator — the 'board' stand-in.

The paper validates its analytical models against board-level FPGA
measurements (Figs. 4-5, avg. 1.15% / 2.17% error). Without hardware, we
validate against this independent simulator: it executes the *schedule*
(columns through pipeline stages, tile groups through the generic array)
with an explicit shared-DRAM server and double-buffered weight fetches,
rather than evaluating closed-form latency formulas. Where the analytic
model assumes perfect overlap and a static bandwidth split, the simulator
serializes real requests through one FIFO DRAM port — so agreement is a
meaningful check, not an identity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

from repro_torch.core.analytical.generic import GenericDesign, generic_layer_latency
from repro_torch.core.analytical.pipeline import PipelineDesign, StageConfig
from repro_torch.core.hardware import FPGASpec
from repro_torch.core.workload import Workload


class DramPort:
    """Single FIFO memory port serving byte requests at fixed bandwidth."""

    def __init__(self, bw_bytes: float):
        self.bw = bw_bytes
        self.free_at = 0.0
        self.bytes_served = 0.0

    def request(self, t_req: float, nbytes: float) -> float:
        """Returns completion time of a transfer requested at t_req."""
        start = max(t_req, self.free_at)
        done = start + nbytes / self.bw
        self.free_at = done
        self.bytes_served += nbytes
        return done


@dataclass
class SimResult:
    image_interval: float       # steady-state seconds per image
    total_time: float
    throughput_imgs: float
    gops: float
    dram_utilization: float


def simulate_pipeline(
    design: PipelineDesign,
    spec: FPGASpec,
    n_images: int = 4,
    batch: int = None,
) -> SimResult:
    """Column-granular simulation of the fine-grained pipeline.

    Stage i, column c of image m starts once (a) stage i-1 produced the
    input columns feeding c, (b) the weight group containing c is
    resident (each stage streams its *full* weight set once per cached-
    column group through its provisioned DMA channel — the column-based
    cache trade), and (c) the stage finished its previous column.

    DNNBuilder provisions each stage a dedicated DMA stream with an
    AXI-bus share; Algorithm 2's BW_i allocation is that share and the
    analytic model requires sum(BW_i) <= BW_total. The simulator honours
    the same provisioning (one DramPort per stage at BW_i) but executes
    the *schedule* event-accurately: quantized column groups, weight-tile
    streaming through a 3-deep FIFO (one tile computing, up to two in
    flight — absorbs ragged last groups), cross-stage column dependencies
    with pooling/stride column mapping, and cross-image stage occupancy —
    none of which the closed-form Eq. 1/2 model sees.
    """
    stages = design.stages
    freq = design.freq_hz
    wbits = design.wbits
    b = design.batch if batch is None else batch
    ports = [DramPort(max(st.bw_bytes, 1e-3)) for st in stages]

    n_cols = [max(1, st.layer.w_out) for st in stages]
    # batch-major: one "column" event = that column of all b images
    t_col = [b * st.compute_cycles() / n_cols[i] / freq
             for i, st in enumerate(stages)]
    wb = [st.layer.weight_bytes(wbits) for st in stages]

    # finish[i][c] for current batch; prev batch's finish for stage busy.
    finish_prev_img = [[0.0] * nc for nc in n_cols]
    # FIFO gating: fetch of global weight group G may begin once group
    # G-2 started computing (3 tile slots). Keep each stage's last two
    # group compute-start times from the previous batch.
    gate_prev = [[0.0, 0.0] for _ in stages]
    first_done = last_done = 0.0

    for m in range(n_images):
        finish = [[0.0] * nc for nc in n_cols]
        gate_next = [[0.0, 0.0] for _ in stages]
        for i, st in enumerate(stages):
            n_groups = (n_cols[i] + st.col - 1) // st.col
            group_bytes = wb[i]      # full weight set per column group
            group_ready = [0.0] * n_groups
            group_start = [0.0] * n_groups
            # issue the first (up to two) fetches of this batch, gated on
            # the previous batch's last two group starts
            g0_gate, g1_gate = (gate_prev[i] if m > 0 else (0.0, 0.0))
            group_ready[0] = ports[i].request(g0_gate, group_bytes)
            if n_groups > 1:
                group_ready[1] = ports[i].request(g1_gate, group_bytes)
            for c in range(n_cols[i]):
                g = c // st.col
                if i > 0:
                    # column c of stage i consumes input columns up to
                    # ceil((c+1) * n_cols[i-1] / n_cols[i]) of stage i-1
                    # (pool/stride column mapping; receptive-field halo
                    # absorbed by the +1 column the cache holds).
                    c_prev = min(n_cols[i - 1] - 1,
                                 ((c + 1) * n_cols[i - 1]) // n_cols[i])
                    ready_in = finish[i - 1][c_prev]
                else:
                    ready_in = 0.0 if m == 0 else finish_prev_img[0][c]
                busy = finish[i][c - 1] if c > 0 else (
                    finish_prev_img[i][-1] if m > 0 else 0.0)
                start = max(ready_in, busy, group_ready[g])
                if c == g * st.col:          # first column of group g
                    group_start[g] = start
                    # slot freed by group g-1's retirement: fetch g+2
                    if g + 2 < n_groups and group_ready[g + 2] == 0.0:
                        group_ready[g + 2] = ports[i].request(
                            start, group_bytes)
                finish[i][c] = start + t_col[i]
            if n_groups >= 2:
                gate_next[i] = [group_start[-2], group_start[-1]]
            else:
                # single group: gates for next batch's groups 0 and 1
                gate_next[i] = [gate_prev[i][1] if m > 0 else 0.0,
                                group_start[-1]]
        finish_prev_img = finish
        gate_prev = gate_next
        if m == n_images - 2:
            first_done = finish[-1][-1]
        if m == n_images - 1:
            last_done = finish[-1][-1]

    interval = max(last_done - first_done, 1e-12) / b
    ops = sum(st.layer.ops for st in stages)
    served = sum(p.bytes_served for p in ports)
    return SimResult(
        image_interval=interval,
        total_time=last_done,
        throughput_imgs=1.0 / interval,
        gops=ops / interval / 1e9,
        dram_utilization=served / (spec.bw_bytes * last_done),
    )


def simulate_generic(
    design: GenericDesign,
    spec: FPGASpec,
    batch: int = 1,
) -> SimResult:
    """Row-granular simulation of the reusable MAC array.

    Three provisioned DMA channels (the analytic model's static
    BW_w/BW_ifm/BW_ofm split) feed the array. Each layer runs its chosen
    dataflow at *row* granularity — the engine's line-buffer streams
    input rows and computes as they arrive (fill latency = 1 row), with
    ping-pong prefetch of the next group's weights/rows and write-back of
    output rows as produced. Layer boundaries do not overlap (buffers are
    repurposed), matching the model's per-layer sum. What the sim adds
    over Eqs. 3-10: first-group fill, ragged tiling, FIFO contention
    inside each channel, and the physical (not formulaic) ofm traffic
    under WS.
    """
    import math

    hw = design.hw
    freq = design.freq_hz
    pw = DramPort(max(hw.bw_w, 1e-3))
    pi = DramPort(max(hw.bw_ifm, 1e-3))
    po = DramPort(max(hw.bw_ofm, 1e-3))
    t = 0.0

    for layer, df in zip(design.layers, design.dataflows):
        cycles = (layer.h_out * layer.w_out * layer.r * layer.s
                  * math.ceil(layer.cin / hw.cpf)
                  * math.ceil(layer.cout / hw.kpf))
        w_bytes = layer.weight_bytes(design.wbits)
        ifm_bytes = layer.in_bytes(design.abits)
        ofm_bytes = layer.h_out * layer.w_out * layer.cout * design.abits / 8.0
        rows = max(1, layer.h_out)
        compute_done = t
        last_ofm = t

        if df == "IS":
            # groups of output rows, sized by the ping-pong accum buffer
            g = max(1, math.ceil(ofm_bytes / (hw.cap_abuf / 2.0)))
            g = min(g, rows)
            rows_per_g = math.ceil(rows / g)
            for _ in range(batch):
                # weights are re-fetched once per group (Eq. 8's G_fm*L_w)
                w_ready = [0.0] * g
                w_ready[0] = pw.request(compute_done, w_bytes)
                img_start = compute_done
                for gi in range(g):
                    r0 = gi * rows_per_g
                    r1 = min(rows, r0 + rows_per_g)
                    if gi + 1 < g:      # ping-pong: prefetch next weights
                        w_ready[gi + 1] = pw.request(
                            max(img_start, compute_done), w_bytes)
                    for r in range(r0, r1):
                        # input rows stream once per image through pi;
                        # cumulative FIFO delivery = line-buffer fill
                        row_ready = pi.request(img_start, ifm_bytes / rows)
                        start = max(compute_done, w_ready[gi], row_ready)
                        compute_done = start + (cycles / rows) / freq
                        last_ofm = po.request(compute_done,
                                              ofm_bytes / rows)
            t = max(compute_done, last_ofm)
        else:
            # WS: weight groups along CHout, sized by the weight buffer
            g = max(1, math.ceil(w_bytes / (hw.cap_wbuf / 2.0)))
            w_ready = pw.request(compute_done, w_bytes / g)
            for gi in range(g):
                next_w = (pw.request(max(t, compute_done), w_bytes / g)
                          if gi + 1 < g else 0.0)
                for _ in range(batch):
                    img_start = compute_done
                    for r in range(rows):
                        row_ready = pi.request(img_start, ifm_bytes / rows)
                        start = max(compute_done, w_ready, row_ready)
                        compute_done = start + (cycles / g / rows) / freq
                        last_ofm = po.request(compute_done,
                                              ofm_bytes / g / rows)
                if gi + 1 < g:
                    w_ready = next_w
            t = max(compute_done, last_ofm)

    interval = max(t / batch, 1e-12)
    ops = sum(l.ops for l in design.layers)
    served = pw.bytes_served + pi.bytes_served + po.bytes_served
    return SimResult(
        image_interval=interval,
        total_time=t,
        throughput_imgs=1.0 / interval,
        gops=ops / interval / 1e9,
        dram_utilization=served / (spec.bw_bytes * t),
    )


def simulate(design, spec: FPGASpec, **kw) -> SimResult:
    """Dispatch on the design type (pipeline vs generic section)."""
    if isinstance(design, PipelineDesign):
        return simulate_pipeline(design, spec, **kw)
    if isinstance(design, GenericDesign):
        return simulate_generic(design, spec, **kw)
    raise TypeError(f"cannot simulate {type(design).__name__}; expected "
                    f"PipelineDesign or GenericDesign")


def simulate_workload(workload, spec: FPGASpec, paradigm: int = 1,
                      batch: int = 1, wbits: int = 16, abits: int = 16,
                      ) -> SimResult:
    """Workload-IR entry point: run the paradigm's level-2 optimizer on
    a CNN-frontend :class:`Workload`, then execute the resulting
    schedule event-accurately. The independent 'board' measurement for
    any registered workload in one call."""
    from repro_torch.core.analytical.generic import generic_dse
    from repro_torch.core.analytical.pipeline import pipeline_performance

    wl = Workload.coerce(workload)
    if paradigm == 1:
        design = pipeline_performance(wl, spec, batch, wbits, abits)
        return simulate_pipeline(design, spec)
    if paradigm == 2:
        design = generic_dse(wl, spec, batch, wbits, abits)
        return simulate_generic(design, spec, batch)
    raise ValueError(f"paradigm must be 1|2 (pipeline|generic), got "
                     f"{paradigm}")
