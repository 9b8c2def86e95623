"""Accelerator models of the port: the shared evaluation vocabulary, the
FPGA-domain models of the paper (paradigms 1-3), the one-card analytic
model and the measured model."""
from repro_torch.core.analytical.interface import (
    AcceleratorModel,
    DesignPoint,
    EvalResult,
)
from repro_torch.core.analytical.pipeline import (
    PipelineDesign,
    PipelineModel,
    allocate_bandwidth,
    allocate_compute,
    pipeline_performance,
)
from repro_torch.core.analytical.generic import (
    GenericDesign,
    GenericModel,
    generic_dse,
    generic_layer_latency,
    generic_performance,
)
from repro_torch.core.analytical.hybrid import (
    HybridDesign,
    HybridModel,
    hybrid_performance,
)
from repro_torch.core.analytical.gpu_model import (
    INT8_LOGIT_DEV_PROXY,
    GPUAnalysis,
    GPUModel,
    GPUPlan,
    hbm_footprint,
)
from repro_torch.core.analytical.measured import (
    CALIB_OP_KIND,
    CALIBRATION_VERSION,
    ENTRY_FIELDS,
    MEASURED_MATCH_FACTOR,
    CalibrationMissing,
    MeasuredModel,
    load_calibration,
)

__all__ = [
    "AcceleratorModel", "DesignPoint", "EvalResult",
    "PipelineDesign", "PipelineModel", "allocate_compute",
    "allocate_bandwidth", "pipeline_performance",
    "GenericDesign", "GenericModel", "generic_layer_latency",
    "generic_dse", "generic_performance",
    "HybridDesign", "HybridModel", "hybrid_performance",
    "INT8_LOGIT_DEV_PROXY", "GPUAnalysis", "GPUModel", "GPUPlan",
    "hbm_footprint",
    "CALIB_OP_KIND", "CALIBRATION_VERSION", "ENTRY_FIELDS",
    "MEASURED_MATCH_FACTOR", "CalibrationMissing", "MeasuredModel",
    "load_calibration",
]
