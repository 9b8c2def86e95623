"""Distribution substrate of the port: logical-axis sharding recipes, the
port's placement of a model on a mesh (serving and the sharded train
step: ``serve.sharded``, ``train.loop``), GPipe over a ``stage`` axis,
and the fault-tolerance hooks with the elastic mesh re-plan. MoE, SSM,
hybrid and audio models on a mesh are ROADMAP.md Queue 1 item 12's next
slice."""
from repro_torch.dist.fault import (StepMonitor, StragglerEvent, Watchdog,
                                    pow2_mesh_shape)
from repro_torch.dist.pipeline import pipeline_apply, stage_split
from repro_torch.dist.sharding import (DECODE_RECIPE, IS_RECIPE,
                                       IS_SEQ_RECIPE, RECIPES, WS_RECIPE,
                                       WS_SEQ_RECIPE, Placement, Recipe,
                                       SpecDrop, TreeLayout, axis_rules,
                                       param_sharding_tree, reset_spec_drops,
                                       sanitize_spec, shard_tree,
                                       spec_drop_count, spec_drops, use_mesh)

__all__ = ["DECODE_RECIPE", "IS_RECIPE", "IS_SEQ_RECIPE", "Placement",
           "RECIPES", "Recipe", "SpecDrop", "StepMonitor", "StragglerEvent",
           "TreeLayout", "WS_RECIPE", "WS_SEQ_RECIPE", "Watchdog",
           "axis_rules", "param_sharding_tree", "pipeline_apply",
           "pow2_mesh_shape", "reset_spec_drops", "sanitize_spec",
           "shard_tree", "spec_drop_count", "spec_drops", "stage_split",
           "use_mesh"]
