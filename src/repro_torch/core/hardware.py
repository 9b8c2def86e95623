"""Hardware specification of the port's target card, shaped like the
reference's ``TPUSpec`` (``repro.core.hardware``) so the measured model
and the rooflines take it in its place.

The H100 SXM figures are NVIDIA's data-sheet values (dense, without
sparsity, at the 700 W power limit). A card set to a lower power limit
runs below them under load; every measurement states the limit beside
it.
"""
from __future__ import annotations

from dataclasses import dataclass


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
)
