"""Distribution substrate of the port: logical-axis sharding recipes, the
port's placement of a model on a mesh, and the fault-tolerance hooks.
The serving engines run on a mesh (``serve.sharded``); training on a
mesh and pipeline parallelism are ROADMAP.md Queue 1 item 12's next
slice."""
from repro_torch.dist.fault import StepMonitor, StragglerEvent, Watchdog
from repro_torch.dist.sharding import (DECODE_RECIPE, IS_RECIPE,
                                       IS_SEQ_RECIPE, RECIPES, WS_RECIPE,
                                       WS_SEQ_RECIPE, Placement, Recipe,
                                       SpecDrop, axis_rules,
                                       param_sharding_tree, reset_spec_drops,
                                       sanitize_spec, shard_tree,
                                       spec_drop_count, spec_drops, use_mesh)

__all__ = ["DECODE_RECIPE", "IS_RECIPE", "IS_SEQ_RECIPE", "Placement",
           "RECIPES", "Recipe", "SpecDrop", "StepMonitor", "StragglerEvent",
           "WS_RECIPE", "WS_SEQ_RECIPE", "Watchdog", "axis_rules",
           "param_sharding_tree", "reset_spec_drops", "sanitize_spec",
           "shard_tree", "spec_drop_count", "spec_drops", "use_mesh"]
