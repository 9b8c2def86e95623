"""Model stack of the port (dense family)."""
from repro_torch.models.convert import load_checkpoint, params_from_numpy
from repro_torch.models.model import (
    CACHE_AXES,
    ModelRuntime,
    cache_spec,
    cache_token_budget,
    cast_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    param_defs,
    prefill,
)

__all__ = [
    "CACHE_AXES",
    "ModelRuntime",
    "cache_spec",
    "cache_token_budget",
    "cast_params",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "load_checkpoint",
    "param_defs",
    "params_from_numpy",
    "prefill",
]
