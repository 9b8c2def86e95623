"""Distribution substrate of the port: the fault-tolerance hooks. Sharding
recipes and pipeline parallelism wait for the multi-GPU slice (ROADMAP.md
Queue 1 item 12)."""
from repro_torch.dist.fault import StepMonitor, StragglerEvent, Watchdog

__all__ = ["StepMonitor", "StragglerEvent", "Watchdog"]
