"""Hardware specifications: the paper's FPGA boards and the port's card.

* :class:`FPGASpec`: the paper's own targets (KU115, ZC706, VU9P,
  ZCU102), copied from the reference's ``repro.core.hardware`` for the
  FPGA-domain models (paradigms 1-3) and their DSE.
* :class:`GPUSpec`: the port's target card, shaped like the reference's
  ``TPUSpec`` so the measured model, the one-card model
  (``gpu_model``) and the rooflines take it in its place.

The H100 SXM figures are NVIDIA's data-sheet values (dense, without
sparsity, at the 700 W power limit). A card set to a lower power limit
runs below them under load; every measurement states the limit beside
it. The links price a mesh of cards (``core.roofline``): NVLink within
a node of :attr:`GPUSpec.node_size` cards, the network card across
nodes.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FPGASpec:
    """FPGA resource budget (the paper's C_max / M_max / BW_max)."""

    name: str
    dsp: int                 # DSP48 slices
    bram18k: int             # 18 Kb block-RAM units
    bw_bytes: float          # external memory bandwidth, bytes/s
    lut: int = 600_000       # logic budget (caps per-stage control overhead)
    freq_hz: float = 200e6   # paper uses 200 MHz throughout

    @property
    def bram_bytes(self) -> float:
        return self.bram18k * 18 * 1024 / 8.0

    def macs_per_dsp(self, bits: int) -> float:
        """alpha/2 in the paper's Eq. 11: MACs one DSP finishes per cycle."""
        if bits <= 8:
            return 2.0   # alpha = 4
        return 1.0       # alpha = 2 (16-bit)

    def peak_gops(self, bits: int) -> float:
        """alpha * DSP * FREQ (Eq. 11 denominator), in GOP/s."""
        return 2.0 * self.macs_per_dsp(bits) * self.dsp * self.freq_hz / 1e9


# Board budgets. DSP/BRAM/LUT from Xilinx datasheets; DRAM bandwidth from
# the standard board configurations used by DNNBuilder / HybridDNN
# (KU115 cards carry 2x DDR4-2400 banks; ZC706 uses the PL-side 64-bit
# DDR3-1600 SODIMM = 12.8 GB/s — the DNNBuilder configuration; VU9P
# cards carry 4x DDR4-2400).
KU115 = FPGASpec("KU115", dsp=5520, bram18k=4320, bw_bytes=38.4e9, lut=663_360)
ZC706 = FPGASpec("ZC706", dsp=900, bram18k=1090, bw_bytes=12.8e9, lut=218_600)
VU9P = FPGASpec("VU9P", dsp=6840, bram18k=4320, bw_bytes=76.8e9, lut=1_182_240)
ZCU102 = FPGASpec("ZCU102", dsp=2520, bram18k=1824, bw_bytes=19.2e9, lut=274_080)

FPGAS = {s.name: s for s in (KU115, ZC706, VU9P, ZCU102)}


@dataclass(frozen=True)
class GPUSpec:
    """Per-card budget: peak rates by operand type, memory and its
    bandwidth, the shared memory one block may use, the SM count."""

    name: str
    peak_flops_bf16: float          # tensor cores, bf16 (and fp16)
    peak_flops_int8: float          # tensor cores, int8 (ops/s)
    peak_flops_f32: float           # CUDA cores, f32, outside the tensor cores
    hbm_bytes: float
    hbm_bw: float                   # bytes/s
    smem_per_block: int             # bytes, opt-in dynamic shared memory
    sms: int
    nvlink_bw: float = 0.0          # bytes/s each direction, within a node
    network_bw: float = 0.0         # bytes/s each direction, across nodes
    node_size: int = 8              # cards one NVLink domain joins

    def peak_flops(self, dtype: str = "bfloat16") -> float:
        """Peak operations/s for operands of ``dtype``."""
        if dtype == "int8":
            return self.peak_flops_int8
        if dtype == "float32":
            return self.peak_flops_f32
        return self.peak_flops_bf16


H100_SXM = GPUSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,
    peak_flops_int8=1979e12,
    peak_flops_f32=67e12,
    hbm_bytes=80e9,
    hbm_bw=3.35e12,
    smem_per_block=232_448,
    sms=132,
    # NVIDIA H100 Tensor Core GPU data sheet: NVLink 900 GB/s per SXM
    # card, both directions together (18 fourth-generation links)
    nvlink_bw=450e9,
    # NVIDIA DGX H100 data sheet: eight ConnectX-7 network cards of
    # 400 Gb/s each, one a GPU
    network_bw=50e9,
    node_size=8,
)


def ring_collective_bytes(payload: int, n: int, kind: str) -> float:
    """Bytes crossing each participant's links for ring collectives.

    all-reduce = reduce-scatter + all-gather = 2(n-1)/n * payload;
    all-gather / reduce-scatter = (n-1)/n * payload;
    all-to-all = (n-1)/n * payload;  collective-permute = payload.
    """
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * payload
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return (n - 1) / n * payload
    if kind == "collective-permute":
        return float(payload)
    raise ValueError(f"unknown collective kind {kind!r}")
