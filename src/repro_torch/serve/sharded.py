"""Sharded serving of the port: the slot batch on a device mesh
(counterpart of ``repro.serve.sharded``).

:class:`ShardedServeEngine` is the one-device engine with its placement
swapped: the parameters are laid out by a ``dist.sharding`` recipe
(default :data:`~repro_torch.dist.sharding.DECODE_RECIPE`: weights
resident and tensor-parallel over ``model``, the cache's batch over
the batch axes, ``pod`` x ``data``), each rank copying only its block onto its device; the cache
is built at its block shapes; and every device call runs under the mesh
and the recipe, so the model takes its tensor-parallel forms.

It runs SPMD, one process a rank (``launch.mesh.run_mesh``): every rank
runs the same host engine (scheduler, sampler, admission, stats) and
only the device work splits. Each rank decodes its own slots (block
``pod * D + data``); the logits of every slot are gathered over the
batch axes at the end of each step and a prefill's logits are broadcast
from the first batch rank over them, so every rank samples the same tokens and keeps the same host state.
Rank 0's ``run()`` is the result; the sharded engine serves the same
tokens as the one-device engine (``tests/test_torch_multidevice.py``,
``tests/test_torch_mesh_moe.py``, ``tests/test_torch_mesh_ssm.py``).
Every decoder family runs: dense and vlm, the MoE (expert-parallel or
expert-split), the SSM (head-aligned, no pages: its state is O(1) a
slot) and the hybrid (its shared blocks' K/V contiguous per slot or
paged, its state per slot). Every recipe of ``RECIPES`` serves, and
their ``+zero3`` forms (``dist.sharding.get_recipe``): where a recipe
splits the model dim over ``data`` (``IS``, ``*+zero3``: ZeRO-3-style
inference) a rank holds its block of every layer and gathers each layer
whole just before it runs (``models.model``), so it serves the tokens
of the same recipe without the ``data`` split, bit for bit
(``tests/test_torch_mesh_zero3.py``).
:func:`mesh_forward` runs the non-causal forward of an encoder (hubert)
or any model's logits on a mesh.
"""
from __future__ import annotations

import dataclasses
from contextlib import ExitStack
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.dist.sharding import (DECODE_RECIPE, Recipe, axis_rules,
                                       default_recipe, get_recipe,
                                       shard_tree, use_mesh)
from repro_torch.models.model import axes_tree, forward, leaf_dtype
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.paged import PagedServeEngine
from repro_torch.tree import tree_leaves


class ShardedServeEngine(ServeEngine):
    """``ServeEngine`` on ``mesh`` (a ``launch.mesh.Mesh``) under
    ``recipe`` (a ``Recipe`` or its name, default ``decode``).
    ``params`` is the whole tree (f32 masters or cast), on the CPU or on
    a device this process can read (CUDA IPC); only this rank's blocks
    are copied, each cast as ``cast_params`` casts it."""

    def __init__(self, params, cfg, rt, mesh,
                 recipe: Optional[Union[Recipe, str]] = None, **kw):
        self.mesh = mesh
        if isinstance(recipe, str):
            recipe = get_recipe(recipe)
        self.recipe = recipe if recipe is not None else DECODE_RECIPE
        self.placement = mesh.placement(cfg, self.recipe)
        rt = dataclasses.replace(rt, device=str(mesh.device))
        params = shard_tree(params, axes_tree(cfg), self.recipe, mesh, cfg,
                            dtype=lambda path: leaf_dtype(path, rt))
        super().__init__(params, cfg, rt, **kw)
        pl = self.placement
        blk = pl.slot_block(self.n_slots)
        if (blk.stop - blk.start) * pl.batch_ranks != self.n_slots:
            raise ValueError(
                f"n_slots={self.n_slots} does not divide over "
                f"{' x '.join(f'{a}={pl.sizes[a]}' for a in pl.batch_axes)}"
                f": each batch rank decodes its own block of the slots")
        self._slot_lo, self._slot_hi = blk.start, blk.stop

    # -------------------------------------------------------- placement hooks
    def _ctx(self):
        stack = ExitStack()
        stack.enter_context(use_mesh(self.mesh))
        stack.enter_context(axis_rules(self.recipe))
        return stack

    def _place_cache(self, cache):
        """The cache as built under the mesh: every leaf must be this
        rank's block of the global spec."""
        axes = self._cache_axes()
        with use_mesh(None):        # no mesh: the whole cache's spec
            spec = self._global_spec()
        for name, leaf in cache.items():
            want = tuple(spec[name][0])
            block = self.placement.local_shape(axes[name], want, name)
            if tuple(leaf.shape) != block:
                raise RuntimeError(f"cache leaf {name!r} is "
                                   f"{tuple(leaf.shape)} on this rank, "
                                   f"not its block {block} of {want}")
        return cache

    def _global_spec(self):
        from repro_torch.models.model import cache_spec
        return cache_spec(self.cfg, self.n_slots, self.max_len,
                          self.rt.dtype, self.rt.kv_dtype)

    def _local_slots(self, slots):
        lo, hi = self._slot_lo, self._slot_hi
        keep = [j for j, s in enumerate(slots) if lo <= s < hi]
        return [slots[j] - lo for j in keep], keep

    def _host_logits(self, logits: torch.Tensor,
                     prefill: bool = False) -> np.ndarray:
        if prefill:
            # every batch rank computed these rows: sample the first
            # rank's, so the host states cannot part
            logits = self.mesh.broadcast(logits, self.mesh.batch_axis)
        return logits.float().cpu().numpy()

    def _decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's slots decode; every slot's logits come back."""
        logits = super()._decode(tokens[self._slot_lo:self._slot_hi])
        return self.placement.gather_batch(logits, 0)


class ShardedPagedServeEngine(ShardedServeEngine, PagedServeEngine):
    """The paged pool on a mesh: ``kp``/``vp`` (and the int8 scales)
    hold this rank's K/V heads of every page and are whole over
    ``data``, where the page tables and ``pos`` split with the slots.
    Every rank runs the same page allocator, so page ids agree; each
    step's new rows reach every rank's pool (``decode_step_paged``).
    Placement from :class:`ShardedServeEngine`, paging from
    :class:`PagedServeEngine`."""

    def _global_spec(self):
        from repro_torch.models.model import paged_cache_spec
        return paged_cache_spec(self.cfg, self.n_slots, self.n_pages,
                                self.page_size, self.max_len, self.rt.dtype,
                                self.rt.kv_dtype)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def mesh_serve(mesh, params, cfg, runs: Sequence[Dict[str, Any]],
               recipe: Optional[Union[Recipe, str]] = None
               ) -> List[Dict[str, Any]]:
    """One rank's serving runs, for ``launch.mesh.run_mesh``: each run
    (a dict of ``rt``, ``requests`` as dicts of :class:`Request`'s
    fields, ``engine_kw`` and ``paged``) builds its sharded engine over
    ``params`` and serves; per run, the tokens of each request id, the
    stats, this rank's parameter and cache bytes and its cache leaves'
    shapes."""
    out = []
    for run in runs:
        cls = ShardedPagedServeEngine if run.get("paged") \
            else ShardedServeEngine
        eng = cls(params, cfg, run["rt"], mesh, recipe=recipe,
                  **run["engine_kw"])
        for r in run["requests"]:
            eng.submit(Request(**r))
        done: List[Request] = eng.run()
        out.append({
            "rank": mesh.rank, "coords": dict(mesh.coords),
            "backend": mesh.backend,
            "tokens": {r.rid: list(r.out_tokens) for r in done},
            "stats": dataclasses.asdict(eng.stats),
            "params_bytes": _nbytes(eng.params),
            "cache_bytes": _nbytes(eng.cache),
            "cache_shapes": {k: tuple(v.shape)
                             for k, v in eng.cache.items()},
            "slots": (eng._slot_lo, eng._slot_hi),
        })
        del eng
    return out


def mesh_forward(mesh, params, cfg, runs: Sequence[Dict[str, Any]],
                 recipe: Optional[Union[Recipe, str]] = None
                 ) -> List[Dict[str, Any]]:
    """One rank's forward runs, for ``launch.mesh.run_mesh``: each run (a
    dict of ``rt`` and ``batch``, the global batch as host arrays or
    tensors: each batch rank takes its rows) calls ``forward`` on this
    rank's blocks of ``params`` under ``recipe`` (default the reference
    launcher's prefill recipe); per run the logits of every row
    (gathered over the batch axes, on the CPU), the aux loss and this rank's
    parameter bytes."""
    from repro_torch.data.pipeline import make_global_batch
    if isinstance(recipe, str):
        recipe = get_recipe(recipe)
    recipe = recipe if recipe is not None else default_recipe(
        cfg, "prefill", mesh.sizes.get("model", 1))
    out = []
    for run in runs:
        rt = dataclasses.replace(run["rt"], device=str(mesh.device))
        with use_mesh(mesh), axis_rules(recipe), torch.no_grad():
            blocks = shard_tree(params, axes_tree(cfg), recipe, mesh, cfg,
                                dtype=lambda path: leaf_dtype(path, rt))
            batch = make_global_batch(run["batch"], mesh)
            logits, aux = forward(blocks, cfg, batch, rt)
            logits = mesh.all_gather(logits, mesh.batch_axis, 0)
        out.append({"rank": mesh.rank, "coords": dict(mesh.coords),
                    "backend": mesh.backend, "recipe": recipe.name,
                    "logits": logits.float().cpu(), "aux": float(aux),
                    "params_bytes": _nbytes(blocks)})
        del blocks
    return out
