"""AdamW with cosine and WSD (warmup-stable-decay) schedules (counterpart
of ``repro.train.optim``).

The arithmetic is the reference's, op for op: the learning rate in f32
from an f32 step, gradients clipped by their f32 global norm, bias
corrections from the f32 step, and the update in f32, cast back to the
parameter's dtype. Moments take the parameter's dtype (the reference's
``zeros_like``); the step is an int32 tensor.

WSD is the MiniCPM schedule [arXiv:2404.06395]: linear warmup, a long
stable plateau at the peak rate and a short (10 %) exponential decay;
minicpm-2b selects it through ``cfg.lr_schedule``.

Where the reference returns new trees, :func:`adamw_update` writes the
new parameters, moments and step into the tensors it is given, as
``torch.optim`` does: a second copy of the f32 weights and moments
(32.6 GB for minicpm-2b) would not fit beside the first on one card.
With the port's f32 masters every value is the reference's; a bf16
parameter's moments stay bf16, where the reference's become f32 after
the first update. A leaf of more than :data:`UPDATE_SLICE` elements is
updated in slices along its first axis (the stacked layers): the
update's f32 temporaries, about six of a slice's size, would otherwise
take 35 GB for zamba2-2.7b's stacked ``in_proj`` (5.8 GB in f32) beside
its 40 GB of weights, moments and gradients. The update is elementwise,
so the values are the same.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


#: Elements of a leaf that one slice of the update covers (2^28: 1 GiB
#: in f32).
UPDATE_SLICE = 1 << 28


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"       # cosine | wsd | constant
    wsd_decay_frac: float = 0.1    # MiniCPM: last 10% of steps decay
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an int tensor), in f32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    if cfg.schedule == "constant":
        return cfg.peak_lr * warm
    if cfg.schedule == "wsd":
        decay_steps = max(1, int(cfg.total_steps * cfg.wsd_decay_frac))
        decay_start = cfg.total_steps - decay_steps
        frac = torch.clamp((step - decay_start) / decay_steps, 0.0, 1.0)
        # exponential anneal peak -> min over the decay window
        decay = torch.pow(cfg.min_lr_frac, frac)
        return cfg.peak_lr * warm * decay
    if cfg.schedule != "cosine":
        raise ValueError(f"schedule {cfg.schedule!r} not supported; "
                         f"available: cosine, wsd, constant")
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    lo = cfg.min_lr_frac
    return cfg.peak_lr * warm * (lo + (1 - lo) * cos)


def adamw_init(params) -> Dict[str, Any]:
    """Zero moments of each parameter's shape, dtype and device, and an
    int32 step on the device of the first leaf."""
    zeros = lambda: tree_map(torch.zeros_like, params)   # noqa: E731
    dev = tree_leaves(params)[0].device
    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state,
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step -> (params, state, {'lr', 'grad_norm'}). The new
    values are written into ``params`` and ``state``'s tensors, leaf by
    leaf, and those trees are returned."""
    step = state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)

    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** (step.float() + 1)
    bc2 = 1 - b2 ** (step.float() + 1)

    def upd_slice(p, g, mu, nu):
        g = g.float() * scale
        pf = p.float()
        mu_new = b1 * mu + (1 - b1) * g
        nu_new = b2 * nu + (1 - b2) * torch.square(g)
        mhat = mu_new / bc1
        nhat = nu_new / bc2
        delta = mhat / (torch.sqrt(nhat) + cfg.eps) + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
        mu.copy_(mu_new)
        nu.copy_(nu_new)

    def upd(p, g, mu, nu):
        if p.numel() <= UPDATE_SLICE:
            return upd_slice(p, g, mu, nu)
        rows = max(1, UPDATE_SLICE // (p.numel() // len(p)))
        for parts in zip(*(t.split(rows) for t in (p, g, mu, nu))):
            upd_slice(*parts)

    tree_map(upd, params, grads, state["mu"], state["nu"])
    step += 1
    return params, state, {"lr": lr, "grad_norm": gnorm}
