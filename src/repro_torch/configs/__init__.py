"""Architecture registry of the port: ``--arch <id>`` resolution.

Holds only the archs the port can run end to end. The other archs of
the reference registry come with their slices (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import re

from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    SSMConfig,
    smoke_config,
)
from repro_torch.configs.minicpm_2b import CONFIG as _minicpm

ARCHS = {cfg.name: cfg for cfg in (_minicpm,)}


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
        f"Queue 1: MoE, SSM/hybrid and the remaining families follow the "
        f"paged engine); available: {sorted(ARCHS)}")


__all__ = [
    "ARCHS",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "get_arch",
    "smoke_config",
]
