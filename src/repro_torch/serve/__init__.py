"""Serving stack of the port: contiguous-cache continuous batching."""
from repro_torch.serve.engine import EngineStats, Request, ServeEngine
from repro_torch.serve.sampling import Sampler
from repro_torch.serve.scheduler import AdmissionPlan, Scheduler

__all__ = ["AdmissionPlan", "EngineStats", "Request", "Sampler",
           "Scheduler", "ServeEngine"]
