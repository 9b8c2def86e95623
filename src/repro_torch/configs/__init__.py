"""Architecture registry of the port: ``--arch <id>`` resolution.

Holds only the archs the port can run end to end: the dense
``minicpm-2b``, the MoE ``qwen2-moe-a2.7b`` and ``mixtral-8x22b`` and
the pure-SSM ``mamba2-1.3b``. The other archs of the reference registry
come with their slices (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import re

from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    smoke_config,
)
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.minicpm_2b import CONFIG as _minicpm
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2_moe

ARCHS = {cfg.name: cfg for cfg in (_mixtral, _qwen2_moe, _minicpm, _mamba2)}


def _canon(s: str) -> str:
    return re.sub(r"[-_.]", "", s.lower())


def get_arch(name: str) -> ModelConfig:
    """The config of ``name``; ``minicpm_2b`` and ``minicpm-2b`` both
    resolve. Any arch the port has not reached raises ``KeyError``."""
    for key, cfg in ARCHS.items():
        if name == key or _canon(name) == _canon(key):
            return cfg
    raise KeyError(
        f"arch {name!r} is not ported to repro_torch yet (ROADMAP.md, "
        f"Queue 1: the hybrid zamba2-2.7b, the vlm, audio and remaining "
        f"dense archs are queued); available: {sorted(ARCHS)}")


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = [
    "ARCHS",
    "SHAPES",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "ShapeConfig",
    "get_arch",
    "get_shape",
    "smoke_config",
]
