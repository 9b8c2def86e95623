"""Training loop of the port (counterpart of ``repro.train.loop``): a
train step with microbatch gradient accumulation, periodic checkpoints
and the straggler monitor's hooks.

The step runs eagerly (the reference jits it). Gradients come from
autograd over the f32 master weights; the port's kernels run forward
under it with the plain versions' autograd as their backward
(``kernels.dispatch.ref_backward``). Sharding recipes wait for the
multi-GPU slice (ROADMAP.md Queue 1 item 12).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import ModelRuntime, check_device, loss_fn
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = AdamWConfig()
    microbatches: int = 1          # gradient accumulation factor
    log_every: int = 10
    ckpt_every: int = 0            # 0 = disabled
    max_steps: int = 100


def check_recipe(recipe) -> None:
    """Sharding recipes are refused until the multi-GPU slice."""
    if recipe is not None:
        raise NotImplementedError(
            "sharding recipes are not ported yet: they come with the "
            "multi-GPU slice (ROADMAP.md Queue 1 item 12)")


def value_and_grad(cfg: ModelConfig, rt: ModelRuntime, params, batch):
    """(loss, metrics, grads) of :func:`~repro_torch.models.model.loss_fn`
    at ``params``; ``grads`` has the tree of ``params``."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, metrics = loss_fn(leaves, cfg, batch, rt)
    flat = tree_leaves(leaves)
    grads = iter(torch.autograd.grad(loss, flat, allow_unused=True,
                                     materialize_grads=True))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), leaves))


def make_train_step(cfg: ModelConfig, rt: ModelRuntime, tc: TrainConfig,
                    recipe=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params": ..., "opt": ...}, updated in place
    (:func:`~repro_torch.train.optim.adamw_update`). With
    ``tc.microbatches = m > 1`` the batch is split on axis 0 and the m
    microbatches run one after another: the gradients are summed and
    divided by m, the loss sum is divided by m, and the other metrics are
    the last microbatch's (the reference's ``lax.scan``)."""
    check_recipe(recipe)

    def compute_grads(params, batch):
        m = tc.microbatches
        if m <= 1:
            return value_and_grad(cfg, rt, params, batch)
        mbs = [{k: v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))[i]
                for k, v in batch.items()} for i in range(m)]
        acc, lsum = None, 0.0
        for mb in mbs:
            l, metrics, g = value_and_grad(cfg, rt, params, mb)
            acc = g if acc is None else tree_map(torch.add, acc, g)
            lsum = lsum + l
        return lsum / m, metrics, tree_map(lambda g: g / m, acc)

    def train_step(state, batch):
        l, metrics, grads = compute_grads(state["params"], batch)
        params, opt, om = adamw_update(tc.opt, state["params"], grads,
                                       state["opt"])
        return {"params": params, "opt": opt}, {"loss": l, **metrics, **om}

    return train_step


def init_state(params) -> Dict[str, Any]:
    return {"params": params, "opt": adamw_init(params)}


def train_loop(cfg: ModelConfig, rt: ModelRuntime, tc: TrainConfig,
               state: Dict[str, Any], data: Iterable[Dict[str, Any]],
               recipe=None,
               ckpt_fn: Optional[Callable[[int, Dict], None]] = None,
               monitor=None,
               log: Callable[[str], None] = print) -> Dict[str, Any]:
    """Drive ``max_steps`` steps; checkpoint and straggler-monitor hooks.
    Each batch moves to ``rt.device`` before its step."""
    check_recipe(recipe)
    step_fn = make_train_step(cfg, rt, tc)
    dev = check_device(rt.device)
    losses = []
    t0 = time.time()
    for step, batch in enumerate(data):
        if step >= tc.max_steps:
            break
        if monitor is not None:
            monitor.step_started(step)
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
