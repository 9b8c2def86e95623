"""Serving stack of the port: continuous batching over a contiguous or a
paged KV cache, with prefix caching and the int8 KV cache."""
from repro_torch.serve.engine import EngineStats, Request, ServeEngine
from repro_torch.serve.paged import (NULL_PAGE, PagedKVCache,
                                     PagedServeEngine, PagesExhausted,
                                     prefix_page_keys)
from repro_torch.serve.parity import ParityReport, logit_parity
from repro_torch.serve.sampling import Sampler
from repro_torch.serve.scheduler import AdmissionPlan, Scheduler

__all__ = ["AdmissionPlan", "EngineStats", "NULL_PAGE", "PagedKVCache",
           "PagedServeEngine", "PagesExhausted", "ParityReport", "Request",
           "Sampler", "Scheduler", "ServeEngine", "logit_parity",
           "prefix_page_keys"]
