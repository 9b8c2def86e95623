"""The Workload IR and the analytic LM front-end (the port's copy of
``repro.core.workload``, without the CNN and JAX-trace front-ends)."""
from repro_torch.core.workload.ir import (
    ACTIVATION_FLOP_KINDS,
    DTYPE_BYTES,
    OP_KINDS,
    WEIGHT_FLOP_KINDS,
    EmptyWorkloadError,
    Op,
    OpInfo,
    Workload,
    WorkloadError,
    dtype_bytes,
)
from repro_torch.core.workload.lm import (
    lm_block_ops,
    lm_workload,
    model_flops,
    profile_arch,
)

__all__ = [
    "ACTIVATION_FLOP_KINDS", "DTYPE_BYTES", "OP_KINDS", "WEIGHT_FLOP_KINDS",
    "EmptyWorkloadError", "Op", "OpInfo", "Workload", "WorkloadError",
    "dtype_bytes", "lm_block_ops", "lm_workload", "model_flops",
    "profile_arch",
]
