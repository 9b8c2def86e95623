"""Architecture registry of the port: ``--arch <id>`` resolution.

Holds the reference registry's ten archs, each config a copy of the
reference's: the MoE ``mixtral-8x22b`` and ``qwen2-moe-a2.7b``, the dense
``chatglm3-6b``, ``stablelm-12b``, ``minicpm-2b`` and ``starcoder2-3b``,
the VLM backbone ``qwen2-vl-7b``, the audio encoder ``hubert-xlarge``, the
hybrid ``zamba2-2.7b`` and the pure-SSM ``mamba2-1.3b``. Module file names
use underscores; registry ids keep the dashed spelling, and both resolve.
"""
from __future__ import annotations

import re

from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    shape_skip_reason,
    smoke_config,
)
from repro_torch.configs.chatglm3_6b import CONFIG as _chatglm3
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.minicpm_2b import CONFIG as _minicpm
from repro_torch.configs.mixtral_8x22b import CONFIG as _mixtral
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2_moe
from repro_torch.configs.qwen2_vl_7b import CONFIG as _qwen2_vl
from repro_torch.configs.stablelm_12b import CONFIG as _stablelm
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder2
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2

ARCHS = {cfg.name: cfg for cfg in (_mixtral, _qwen2_moe, _chatglm3,
                                   _stablelm, _minicpm, _starcoder2,
                                   _qwen2_vl, _hubert, _zamba2, _mamba2)}


def _canon(s: str) -> str:
    return re.sub(r"[-_.]", "", s.lower())


def get_arch(name: str) -> ModelConfig:
    """The config of ``name``; ``minicpm_2b`` and ``minicpm-2b`` both
    resolve. An unknown name raises ``KeyError``."""
    for key, cfg in ARCHS.items():
        if name == key or _canon(name) == _canon(key):
            return cfg
    raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")


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
    "shape_skip_reason",
    "smoke_config",
]
