"""Training loop of the port (counterpart of ``repro.train.loop``): a
train step with microbatch gradient accumulation under a sharding
recipe, periodic checkpoints and the straggler monitor's hooks.

The step runs eagerly (the reference jits it). Gradients come from
autograd over the f32 master weights; the port's kernels run forward
under it with the plain versions' autograd as their backward
(``kernels.dispatch.ref_backward``).

Under a mesh (``dist.sharding.use_mesh``, one process a rank:
``launch.mesh.run_mesh``) the step runs SPMD under its recipe on this
rank's blocks of the state (:func:`shard_state`): tensor-parallel over
``model`` (the model's forms), data-parallel over the batch axes
(``pod`` x ``data``; ``data`` alone on a mesh without ``pod``), and
under IS/IS_seq with the weights split over ``data`` too, each layer
gathered for its run. Every rank is handed the same global batch;
microbatch i is its global rows ``[i B/m, (i+1) B/m)`` as on one device,
and each batch rank takes its block of it (``data.make_global_batch``,
block ``pod * D + data``). A microbatch splits over the batch axes as
the reference's sanitized ``batch`` spec does (``dist.sharding.
row_split``: ``pod``, then ``data`` where the split still divides the
rows), and the ranks along an axis left out hold the same rows: every
sum below is then divided by all the batch ranks, which counts each
row once. Every leaf's gradient is summed over the batch ranks once
(an all-reduce over ``pod`` x ``data``; for a leaf split over ``data``
the backward of its gather over ``data``, then an all-reduce over
``pod``) and divided by their count; the clipping
norm counts each element of the logical tree once
(``optim.global_norm``: a block's squares, or for the Mamba-2 mixer
each column's, divided by its holders); AdamW updates each block.
Loss, ce and aux are averaged over the batch ranks, so every rank
reports one device's numbers: the MoE aux loss is already the global
batch's on every rank (``models.moe``), its gradient entering once. A
recipe is placement, not semantics: ``tests/test_torch_train_mesh.py``
holds the mesh to one device and to the JAX package.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import batch_dim, make_global_batch
from repro_torch.dist.sharding import (RECIPES, Recipe, TreeLayout,
                                       active_mesh, active_placement,
                                       axis_rules, row_split, shard_tree)
from repro_torch.models.model import (ModelRuntime, axes_tree, check_device,
                                      data_dims, loss_fn, param_defs)
from repro_torch.train.optim import (AdamWConfig, adamw_init, adamw_update,
                                     global_norm)
from repro_torch.tree import tree_leaves, tree_map

#: Elements of one gradient all-reduce (2^26: 256 MiB of f32): the
#: gradients are summed in buckets of this size.
REDUCE_BUCKET = 1 << 26


@dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1          # gradient accumulation factor
    log_every: int = 10
    ckpt_every: int = 0            # 0 = disabled
    max_steps: int = 100


def check_recipe(recipe) -> Optional[Recipe]:
    """``recipe`` as a :class:`~repro_torch.dist.sharding.Recipe`: None,
    a ``Recipe`` or the name of one of ``RECIPES``; any other name is
    refused."""
    if recipe is None or isinstance(recipe, Recipe):
        return recipe
    if recipe not in RECIPES:
        raise ValueError(f"recipe {recipe!r} is not one of RECIPES: "
                         f"{sorted(RECIPES)}")
    return RECIPES[recipe]


def value_and_grad(cfg: ModelConfig, rt: ModelRuntime, params, batch,
                   rows_split=None):
    """(loss, metrics, grads) of :func:`~repro_torch.models.model.loss_fn`
    at ``params`` (``rows_split`` as it takes it); ``grads`` has the tree
    of ``params``."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = loss_fn(leaves, cfg, batch, rt, rows_split)
    flat = tree_leaves(leaves)
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True,
                                     materialize_grads=True))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), leaves))


def microbatch(batch, i: int, m: int):
    """Global rows ``[i B/m, (i+1) B/m)`` of every leaf (the reference's
    reshape to ``(m, B/m, ...)``; an M-RoPE positions leaf splits its
    dim 1)."""
    if m <= 1:
        return batch

    def rows(name, x):
        x = torch.as_tensor(x)
        dim = batch_dim(name, x.dim())
        per = x.shape[dim] // m
        return x.narrow(dim, i * per, per)

    return {k: rows(k, v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The state on a mesh
# ---------------------------------------------------------------------------
def _shapes(defs):
    if isinstance(defs, dict):
        return {k: _shapes(v) for k, v in defs.items()}
    return tuple(defs.shape)


def param_layout(cfg: ModelConfig, pl) -> TreeLayout:
    """Where every parameter (or gradient) lives under the placement
    ``pl``."""
    return TreeLayout(pl, axes_tree(cfg), _shapes(param_defs(cfg)))


def state_layout(cfg: ModelConfig, pl) -> TreeLayout:
    """Where every leaf of a train state ``{params, opt: {mu, nu, step}}``
    lives under the placement ``pl`` (the moments as their parameters;
    the step on every rank)."""
    p = param_layout(cfg, pl)
    return TreeLayout(
        pl, {"params": p.axes, "opt": {"mu": p.axes, "nu": p.axes,
                                       "step": ()}},
        {"params": p.shapes, "opt": {"mu": p.shapes, "nu": p.shapes,
                                     "step": ()}})


def shard_state(params, cfg: ModelConfig, recipe, mesh=None):
    """A fresh train state on this rank of ``mesh`` (default the ambient
    one) under ``recipe``: its blocks of ``params`` (the whole tree, on
    the CPU or read over CUDA IPC), copied leaf by leaf, and zero
    moments of the blocks' shapes."""
    mesh = mesh if mesh is not None else active_mesh()
    blocks = shard_tree(params, axes_tree(cfg), check_recipe(recipe), mesh,
                        cfg)
    return init_state(blocks)


def _sum_grads(grads, dims, pl) -> None:
    """Sum every gradient over the ranks that hold copies of its block,
    in place, in buckets of :data:`REDUCE_BUCKET` elements: a leaf whole
    over ``data`` over the batch ranks (``pod`` x ``data``), a leaf split
    over ``data`` (summed there by its gather's backward, a
    reduce-scatter) over ``pod``."""
    pairs = list(zip(tree_leaves(grads), tree_leaves(dims)))
    sum_in_buckets([g for g, d in pairs if d is None], pl.mesh,
                   pl.batch_axis)
    if pl.sizes.get("pod", 1) > 1:
        sum_in_buckets([g for g, d in pairs if d is not None], pl.mesh,
                       "pod")


def sum_in_buckets(todo, mesh, axis: str) -> None:
    """Sum each tensor of ``todo`` over ``axis`` of ``mesh``, in place, a
    bucket of :data:`REDUCE_BUCKET` elements (or one larger tensor) an
    all-reduce."""
    i = 0
    while i < len(todo):
        j, n = i + 1, todo[i].numel()
        while j < len(todo) and n + todo[j].numel() <= REDUCE_BUCKET:
            n += todo[j].numel()
            j += 1
        flat = mesh.all_reduce(torch.cat([g.reshape(-1).float()
                                          for g in todo[i:j]]), axis)
        o = 0
        for g in todo[i:j]:
            g.copy_(flat[o:o + g.numel()].view_as(g))
            o += g.numel()
        i = j


def make_train_step(cfg: ModelConfig, rt: ModelRuntime, tc: TrainConfig,
                    recipe=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params": ..., "opt": ...}, updated in place
    (:func:`~repro_torch.train.optim.adamw_update`). With
    ``tc.microbatches = m > 1`` the batch is split on axis 0 (microbatch
    i: rows ``[i B/m, (i+1) B/m)``) and the m microbatches run one after
    another: the gradients are summed and divided by m, the loss sum is
    divided by m, and the other metrics are the last microbatch's (the
    reference's ``lax.scan``).

    ``recipe`` (a ``Recipe`` or a name of ``RECIPES``) places the state
    on the ambient mesh: there ``state`` holds this rank's blocks and
    ``batch`` the global batch (module docstring). With no mesh, or a
    mesh of one device, the step is the one-device step. The function's
    ``grads(params, batch)`` returns (loss, metrics, gradients) as the
    step takes them, reduced over the batch ranks."""
    recipe = check_recipe(recipe)

    def compute(pl, params, batch):
        """(loss, metrics, gradients) as the step takes them: on one
        device (``pl`` None) or this rank's, reduced over the batch
        ranks."""
        m = max(1, tc.microbatches)
        acc, lsum = None, 0.0
        for i in range(m):
            mb = microbatch(batch, i, m)
            split = None
            if pl is not None:
                name, leaf = next(iter(mb.items()))
                leaf = torch.as_tensor(leaf)
                split = row_split(leaf.shape[batch_dim(name, leaf.dim())],
                                  pl.sizes)
                mb = make_global_batch(mb, pl.mesh, split)
            l, metrics, g = value_and_grad(cfg, rt, params, mb, split)
            acc = g if acc is None else tree_map(torch.add, acc, g)
            lsum = lsum + l
        n_batch = 1 if pl is None else pl.batch_ranks
        if n_batch > 1:
            _sum_grads(acc, data_dims(cfg, pl), pl)
        scale = m * n_batch
        grads = tree_map(lambda g: g / scale, acc) if scale > 1 else acc
        if pl is None:
            return lsum / m, metrics, grads
        vals = torch.stack([lsum / m, metrics["ce"], metrics["aux"]])
        vals = pl.mesh.all_reduce(vals, pl.batch_axis) / n_batch
        return vals[0], {"ce": vals[1], "aux": vals[2]}, grads

    def grads(params, batch):
        with axis_rules(recipe):
            return compute(active_placement(cfg), params, batch)

    copies_of: Dict[Any, Any] = {}     # each placement's copies of a leaf

    def train_step(state, batch):
        with axis_rules(recipe):
            pl = active_placement(cfg)
            l, metrics, g = compute(pl, state["params"], batch)
            norm = global_norm
            if pl is not None:
                if pl not in copies_of:
                    copies_of[pl] = param_layout(cfg, pl).copies()
                copies = copies_of[pl]

                def norm(tree):
                    return global_norm(tree, copies, pl.mesh.world_sum)
            params, opt, om = adamw_update(tc.opt, state["params"], g,
                                           state["opt"], norm=norm)
        return {"params": params, "opt": opt}, {"loss": l, **metrics, **om}

    train_step.grads = grads
    return train_step


def init_state(params) -> Dict[str, Any]:
    """AdamW's state for ``params`` (whole, or this rank's blocks)."""
    return {"params": params, "opt": adamw_init(params)}


def train_loop(cfg: ModelConfig, rt: ModelRuntime, tc: TrainConfig,
               state: Dict[str, Any], data: Iterable[Dict[str, Any]],
               recipe=None,
               ckpt_fn: Optional[Callable[[int, Dict], None]] = None,
               monitor=None,
               log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Drive ``max_steps`` steps; checkpoint and straggler-monitor hooks.
    Each batch moves to ``rt.device`` before its step; under a recipe on
    the ambient mesh every rank takes the global batch and its step
    keeps the rank's rows. Steps count from 0 whatever the state's step
    (the reference's ``enumerate(data)``, kept for parity)."""
    recipe = check_recipe(recipe)
    step_fn = make_train_step(cfg, rt, tc, recipe)
    mesh = active_mesh()
    sharded = recipe is not None and mesh is not None and mesh.devices > 1
    dev = None if sharded else check_device(rt.device)
    losses = []
    t0 = time.time()
    for step, batch in enumerate(data):
        if step >= tc.max_steps:
            break
        if monitor is not None:
            monitor.step_started(step)
        if not sharded:
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if monitor is not None:
            monitor.step_finished(step)
        if tc.log_every and step % tc.log_every == 0:
            dt = time.time() - t0
            log(f"step {step:5d} loss {loss:.4f} "
                f"lr {float(metrics['lr']):.2e} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({dt:.1f}s)")
        if ckpt_fn is not None and tc.ckpt_every \
                and step > 0 and step % tc.ckpt_every == 0:
            ckpt_fn(step, state)
    state["_losses"] = losses
    return state
