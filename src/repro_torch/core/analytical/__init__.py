"""Accelerator models of the port: the shared evaluation vocabulary and
the measured model."""
from repro_torch.core.analytical.interface import DesignPoint, EvalResult
from repro_torch.core.analytical.measured import (
    CALIB_OP_KIND,
    CALIBRATION_VERSION,
    ENTRY_FIELDS,
    MEASURED_MATCH_FACTOR,
    CalibrationMissing,
    MeasuredModel,
    load_calibration,
)

__all__ = ["CALIB_OP_KIND", "CALIBRATION_VERSION", "ENTRY_FIELDS",
           "MEASURED_MATCH_FACTOR", "CalibrationMissing", "DesignPoint",
           "EvalResult", "MeasuredModel", "load_calibration"]
