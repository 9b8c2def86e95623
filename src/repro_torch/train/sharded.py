"""Training runs on one rank of a mesh, for ``launch.mesh.run_mesh``
(the training twin of ``serve.sharded.mesh_serve``).

:func:`mesh_train` drives the sharded train step (``train.loop``) on
this rank's blocks through a list of runs and returns, per run, what a
caller holds against one device: every step's loss, ce, aux, gradient
norm, learning rate and wall time; this rank's state bytes; on request step
0's gradients (assembled whole, or each block against a whole reference
tree), the whole state after the steps, whether every block of this
rank equals its slices of that whole state, a checkpoint written from
the mesh, or a start from one (saved again, so its files can be
compared).
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Sequence

import torch

from repro_torch.ckpt.checkpoint import restore_elastic, save
from repro_torch.dist.sharding import use_mesh
from repro_torch.train.loop import (check_recipe, make_train_step,
                                    param_layout, shard_state, state_layout)
from repro_torch.tree import tree_items, tree_leaves, tree_map


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _grad_deviation(grads, ref, layout) -> Dict[str, Any]:
    """The leaf of this rank's gradient blocks furthest from the whole
    tree ``ref``, each leaf held to its own scale: max |block -
    ref[slices]| over max |ref leaf| (0 where both are 0, inf where the
    reference leaf alone is 0); the worst leaf's path, ratio and two
    maxima."""
    index = dict(tree_items(layout.slices()))
    ref = dict(tree_items(ref))
    worst: Dict[str, Any] = {"rel": -1.0}
    for keys, g in tree_items(grads):
        whole = ref[keys]
        want = whole[index[keys]].to(g.device)
        d = float((g.float() - want.float()).abs().max())
        m = float(whole.abs().max())
        rel = d / m if m else (0.0 if d == 0 else math.inf)
        if rel > worst["rel"]:
            worst = {"leaf": "/".join(keys), "rel": rel,
                     "max_abs_diff": d, "max_abs": m}
    return worst


def mesh_train(mesh, runs: Sequence[Dict[str, Any]]) -> List[Dict]:
    """One rank's train runs. Each run is a dict of ``cfg``, ``params``
    (the whole tree, on the CPU or the caller's card), ``rt``, ``tc``,
    ``recipe`` (a name of ``RECIPES``) and ``batches`` (global host
    batches, one a step), and optionally ``restore`` ((directory, step):
    start from that checkpoint through ``restore_elastic`` instead of
    ``params``, which may then be None; with ``save_restored``, a
    directory, the restored state is saved from this mesh there before
    the steps, so its files can be held to the ones restored from),
    ``grads`` (return step 0's gradients whole, on rank 0),
    ``ref_grads`` (a whole tree: each rank's gradient blocks at step 0
    held against it leaf by leaf, ``grad_dev`` the worst leaf),
    ``gather`` (return the whole state after the steps, on rank 0, and
    check every rank's blocks against it) and
    ``save`` ((directory, step): write the state after the steps from
    the mesh). The seconds a save and a restore took are recorded
    (``save_s``, ``restore_s``)."""
    out = []
    for run in runs:
        cfg, recipe = run["cfg"], check_recipe(run["recipe"])
        rec: Dict[str, Any] = dict(rank=mesh.rank, coords=dict(mesh.coords),
                                   backend=mesh.backend, recipe=recipe.name)
        with use_mesh(mesh):
            pl = mesh.placement(cfg, recipe)
            layout = state_layout(cfg, pl)
            if run.get("restore"):
                d, s = run["restore"]
                t0 = time.perf_counter()
                like = tree_map(lambda _: torch.empty(0, device=mesh.device),
                                layout.shapes)
                state = restore_elastic(d, s, like, layout.slices())
                rec["restore_s"] = time.perf_counter() - t0
                if run.get("save_restored"):
                    save(run["save_restored"], s, state, layout=layout)
            else:
                state = shard_state(run["params"], cfg, recipe)
            rec["state_bytes"] = _nbytes(state)
            step = make_train_step(cfg, run["rt"], run["tc"], recipe)
            if run.get("grads") or run.get("ref_grads") is not None:
                _, _, g = step.grads(state["params"], run["batches"][0])
                if run.get("ref_grads") is not None:
                    rec["grad_dev"] = _grad_deviation(
                        g, run["ref_grads"], param_layout(cfg, pl))
                if run.get("grads"):
                    whole = param_layout(cfg, pl).gather(g)
                    rec["grads"] = whole if mesh.rank == 0 else None
                del g
            keys = ("loss", "ce", "aux", "grad_norm", "lr")
            for k in keys + ("step_ms",):
                rec[k] = []
            for batch in run["batches"]:
                _sync(mesh.device)
                t0 = time.perf_counter()
                state, m = step(state, batch)
                _sync(mesh.device)
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
                for k in keys:
                    rec[k].append(float(m[k]))
            if run.get("gather"):
                whole = layout.gather(state)
                index = dict(tree_items(layout.slices()))
                rec["blocks_equal"] = all(
                    torch.equal(leaf.cpu(), whole_leaf[index[k]])
                    for (k, leaf), (_, whole_leaf) in zip(
                        tree_items(state), tree_items(whole)))
                rec["state"] = whole if mesh.rank == 0 else None
            if run.get("save"):
                d, s = run["save"]
                t0 = time.perf_counter()
                save(d, s, state, layout=layout)
                rec["save_s"] = time.perf_counter() - t0
        out.append(rec)
        del state
    return out

