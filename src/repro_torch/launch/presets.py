"""Scale presets of the port's dry-run (counterpart of
``repro.launch.presets``).

A :class:`Preset` fixes the three scale knobs of a dry-run sweep — the
meshes, the input shapes and the architecture sizes — so the same
per-cell pipeline (``launch.lowering.lower_cell``: recipe, the rank's
step traced on ``meta``, memory/cost/collectives, JSON) runs at two
scales:

* ``full`` — the reference's production meshes, (16, 16) over
  ``(data, model)`` and (2, 16, 16) over ``(pod, data, model)``, with
  the paper's architectures and shapes at full width;
* ``ci`` — a (2, 4) / (2, 2, 2) mesh with ``smoke_config``-reduced
  architectures and shrunken shapes, seconds on a CPU host.

Cell identity (arch/shape names, skip rules, the census) is
preset-independent: a preset only rescales the cells. A mesh here is a
shape, never a process group: the dry-run traces one rank of it
(:class:`~repro_torch.launch.mesh.DryMesh`), so there are no host
devices to force, as the reference must.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

from repro_torch.configs import get_arch, get_shape, smoke_config
from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclass(frozen=True)
class MeshSpec:
    """Mesh geometry as pure data."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def devices(self) -> int:
        return math.prod(self.shape)

    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.shape))


@dataclass(frozen=True)
class Preset:
    """One scale point of the dry-run sweep."""

    name: str
    meshes: Mapping[str, MeshSpec]
    shapes: Mapping[str, ShapeConfig]
    shrink_archs: bool = False
    description: str = ""

    # -- cell resolution ----------------------------------------------------
    def arch(self, name: str) -> ModelConfig:
        cfg = get_arch(name)
        return smoke_config(cfg) if self.shrink_archs else cfg

    def shape(self, name: str) -> ShapeConfig:
        if name not in self.shapes:
            raise KeyError(
                f"unknown shape {name!r} for preset {self.name!r}; "
                f"available: {sorted(self.shapes)}")
        return self.shapes[name]

    def mesh_spec(self, mesh_name: str) -> MeshSpec:
        if mesh_name not in self.meshes:
            raise KeyError(
                f"unknown mesh {mesh_name!r} for preset {self.name!r}; "
                f"available: {sorted(self.meshes)}")
        return self.meshes[mesh_name]


FULL = Preset(
    name="full",
    meshes={
        "single": MeshSpec((16, 16), ("data", "model")),
        "multi": MeshSpec((2, 16, 16), ("pod", "data", "model")),
    },
    shapes={
        "train_4k": get_shape("train_4k"),
        "prefill_32k": get_shape("prefill_32k"),
        "decode_32k": get_shape("decode_32k"),
        "long_500k": get_shape("long_500k"),
    },
    shrink_archs=False,
    description="the reference's 16x16 / 2x16x16 meshes, paper-scale cells",
)

# Shrunken shapes keep the canonical names: cell identity, filenames and
# skip rules (which match on shape *name* and arch flags preserved by
# smoke_config) are shared with the full preset.
CI = Preset(
    name="ci",
    meshes={
        "single": MeshSpec((2, 4), ("data", "model")),
        "multi": MeshSpec((2, 2, 2), ("pod", "data", "model")),
    },
    shapes={
        "train_4k": ShapeConfig("train_4k", 512, 16, "train"),
        "prefill_32k": ShapeConfig("prefill_32k", 1024, 4, "prefill"),
        "decode_32k": ShapeConfig("decode_32k", 1024, 8, "decode"),
        "long_500k": ShapeConfig("long_500k", 4096, 1, "decode"),
    },
    shrink_archs=True,
    description="(2, 4) and (2, 2, 2) meshes, smoke-scale cells (CPU host, "
                "seconds)",
)

PRESETS: Dict[str, Preset] = {p.name: p for p in (FULL, CI)}


def get_preset(name: str) -> Preset:
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]
