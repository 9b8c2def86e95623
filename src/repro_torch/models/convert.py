"""Weights bridge: reference parameters (as numpy) into the port.

The reference draws its weights with ``jax.random``, which torch cannot
reproduce, so parity runs hand the same numbers across as numpy arrays:
either a nested dict of arrays in the reference's tree (stacked
``layers`` axis, ``(in, out)`` projections), or the ``.npy``-per-leaf
checkpoint layout the reference's ``ckpt/checkpoint.py`` writes
(``manifest.json`` + ``<leaf>.npy`` + ``_COMPLETE``), read here without
importing the reference.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import read_leaf
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ParamDef
from repro_torch.models.model import check_device, param_defs


def params_from_numpy(cfg: ModelConfig, tree: Dict[str, Any], device="cuda",
                      dtype: torch.dtype = torch.float32):
    """Torch parameters from a nested dict of numpy arrays. Raises when a
    leaf is missing, extra, or of the wrong shape for ``cfg``."""
    dev = check_device(device)

    def walk(defs, sub, path):
        if isinstance(defs, ParamDef):
            arr = np.asarray(sub)
            if tuple(arr.shape) != tuple(defs.shape):
                raise ValueError(f"leaf {path}: shape {arr.shape} != "
                                 f"{defs.shape} for {cfg.name}")
            return torch.tensor(arr, dtype=dtype, device=dev)   # a copy
        if not isinstance(sub, dict) or set(sub) != set(defs):
            got = sorted(sub) if isinstance(sub, dict) else type(sub)
            raise ValueError(f"node {path or '<root>'}: keys {got} != "
                             f"{sorted(defs)} for {cfg.name}")
        return {k: walk(defs[k], sub[k], f"{path}['{k}']") for k in defs}

    return walk(param_defs(cfg), tree, "")


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Nested dict of numpy arrays from one checkpoint step directory
    (``<dir>/step_<N>``), each leaf read by its manifest dtype; numpy has
    no bf16, so a bf16 leaf comes back as the f32 array of the same
    values (exact). Refuses an incomplete checkpoint."""
    if not os.path.exists(os.path.join(path, "_COMPLETE")):
        raise FileNotFoundError(f"incomplete or missing checkpoint at "
                                f"{path} (no _COMPLETE marker)")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tree: Dict[str, Any] = {}
    for fname, meta in manifest["leaves"].items():
        keys = re.findall(r"\['([^']*)'\]", meta["path"])
        if not keys:
            raise ValueError(f"leaf {fname}: unsupported tree path "
                             f"{meta['path']!r}")
        t = read_leaf(os.path.join(path, fname + ".npy"), meta["dtype"])
        arr = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        if list(arr.shape) != list(meta["shape"]):
            raise ValueError(f"leaf {fname}: shape {arr.shape} != manifest "
                             f"{meta['shape']}")
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr
    return tree
