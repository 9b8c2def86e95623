"""Serving stack of the port: continuous batching over a contiguous or a
paged KV cache, with prefix caching and the int8 KV cache, on one device
or on a mesh (the sharded engines), and the traffic scenario library the
launcher and ``deploy_lint`` share."""
from repro_torch.serve.engine import EngineStats, Request, ServeEngine
from repro_torch.serve.paged import (NULL_PAGE, PagedKVCache,
                                     PagedServeEngine, PagesExhausted,
                                     prefix_page_keys)
from repro_torch.serve.parity import ParityReport, logit_parity
from repro_torch.serve.sampling import Sampler
from repro_torch.serve.scenarios import (SCENARIOS, ArrivalSpec, LengthDist,
                                         Scenario, SLOSpec, get_scenario)
from repro_torch.serve.scheduler import AdmissionPlan, Scheduler
from repro_torch.serve.sharded import (ShardedPagedServeEngine,
                                       ShardedServeEngine, mesh_forward)

__all__ = ["AdmissionPlan", "ArrivalSpec", "EngineStats", "LengthDist",
           "NULL_PAGE", "PagedKVCache", "PagedServeEngine", "PagesExhausted",
           "ParityReport", "Request", "SCENARIOS", "SLOSpec", "Sampler",
           "Scenario", "Scheduler", "ServeEngine", "ShardedPagedServeEngine",
           "ShardedServeEngine", "get_scenario", "logit_parity",
           "mesh_forward", "prefix_page_keys"]
