"""The FPGA-domain event simulator (the port's copy of ``repro.sim``):
an independent 'board' that executes the paradigm-1/2 schedules event by
event, against which the analytical models are checked."""
from repro_torch.sim.simulator import (
    SimResult,
    simulate,
    simulate_generic,
    simulate_pipeline,
    simulate_workload,
)

__all__ = ["SimResult", "simulate", "simulate_generic",
           "simulate_pipeline", "simulate_workload"]
