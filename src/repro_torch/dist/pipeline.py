"""GPipe-style pipeline parallelism over a ``stage`` mesh axis
(counterpart of ``repro.dist.pipeline``).

:func:`stage_split` reshapes a stacked-layer parameter tree ``(L, ...)``
to ``(n_stages, L/n_stages, ...)``; each rank of the ``stage`` axis
holds its stage's block. :func:`pipeline_apply` wraps a stage function
into the pipelined schedule, SPMD over the mesh's processes (one a
rank, ``launch.mesh.run_mesh``).

Schedule: ``T = n_micro + n_stages - 1`` ticks. At tick ``t`` stage 0
takes microbatch ``t`` (while ``t < n_micro``); every stage applies its
layers to its current activation and passes the result to the next
stage (``Mesh.shift``: a ring shift whose backward shifts the gradient
the other way); the last stage commits microbatch ``t - (n_stages-1)``
to the output buffer. The buffer is replicated by a sum over ``stage``
of the last stage's (``Mesh.sum``: its backward is the identity, since
every rank computes the same loss from the same output). Every choice a
stage makes is a ``torch.where`` on a tensor, as the reference's
``jnp.where``: each rank's graph has the same collectives, so the
backward's shifts pair up across ranks. Bubble fraction
``(n_stages-1)/T``, the paper's Eq. 2 "initial latency" term.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.tree import tree_map


def stage_split(tree: Any, n_stages: int) -> Any:
    """Reshape every stacked-layer leaf (L, ...) -> (S, L/S, ...)
    (tensors or numpy arrays)."""

    def split(x):
        L = x.shape[0]
        if L % n_stages:
            raise ValueError(f"layer count {L} not divisible by "
                             f"{n_stages} stages")
        return x.reshape((n_stages, L // n_stages) + tuple(x.shape[1:]))

    return tree_map(split, tree)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   mesh, n_stages: int) -> Callable:
    """Build ``fn(staged, x)``: ``staged`` is this rank's stage block of
    the staged parameters (leaves ``(1, L/n_stages, ...)``: the rows of
    :func:`stage_split`'s output at this rank's ``stage`` coordinate),
    ``x`` is ``(n_micro, mb, ...)``, the same on every rank. Returns the
    pipelined outputs ``(n_micro, mb, ...)``, replicated on every rank,
    differentiable in ``staged``."""
    if mesh.sizes.get("stage") != n_stages:
        raise ValueError(f"mesh {mesh.sizes} has no stage axis of "
                         f"{n_stages}")
    s = mesh.coords["stage"]

    def fn(staged, x):
        local = tree_map(lambda w: w[0], staged)
        n_micro = x.shape[0]
        ticks = n_micro + n_stages - 1
        first = torch.tensor(s == 0, device=x.device)
        state = torch.zeros_like(x[0])
        ybuf = [torch.zeros_like(x[0]) for _ in range(n_micro)]
        for t in range(ticks):
            feed = x[min(t, n_micro - 1)]
            out = stage_fn(local, torch.where(first, feed, state))
            idx = t - (n_stages - 1)
            commit = torch.tensor(s == n_stages - 1 and idx >= 0,
                                  device=x.device)
            slot = min(max(idx, 0), n_micro - 1)
            ybuf[slot] = torch.where(commit, out, ybuf[slot])
            state = mesh.shift(out, "stage")
        mask = float(s == n_stages - 1)
        return mesh.sum(torch.stack(ybuf) * mask, "stage")

    return fn
