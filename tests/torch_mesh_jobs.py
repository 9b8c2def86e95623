"""The rank function of the port's family mesh tests
(``test_torch_mesh_moe.py``, ``test_torch_mesh_ssm.py``,
``test_torch_mesh_zero3.py``): a module that imports the port alone, so
a spawned rank does not import jax.

``run_jobs(mesh, jobs)`` runs each ``(kind, args)`` job in turn on this
rank and returns their results in order: ``serve`` is
``serve.sharded.mesh_serve(mesh, *args)``, ``train``
``train.sharded.mesh_train(mesh, *args)``, ``forward``
``serve.sharded.mesh_forward(mesh, *args)``, ``logits``
:func:`serve_logits` and ``moe_layer`` :func:`moe_layer` and ``step``
``launch.lowering.live_step(mesh, *args)`` (one step of a dry-run cell,
its collectives counted), ``pp`` ``launch.dryrun_pp.live_pp_step(mesh,
*args)`` (the pipeline-parallel train step). One spawn serves, trains
and runs forwards of several models.
"""
import torch

from repro_torch.dist.sharding import Placement
from repro_torch.launch.dryrun_pp import live_pp_step
from repro_torch.launch.lowering import live_step
from repro_torch.serve.sharded import (ShardedServeEngine, mesh_forward,
                                       mesh_serve)
from repro_torch.train.sharded import mesh_train


def _broken_gather(how):
    """``Placement.gather_data`` with its blocks over ``data`` reordered
    (``reorder``: the last first) or one dropped (``drop``: the last
    rank's block zeros): a gather a serving test must catch."""
    def gather_data(self, t, dim):
        whole = self.mesh.gather(t, "data", dim, reduce=True)
        blocks = list(whole.chunk(self.sizes["data"], dim))
        if how == "reorder":
            blocks = blocks[::-1]
        else:
            blocks[-1] = torch.zeros_like(blocks[-1])
        return torch.cat(blocks, dim)
    return gather_data


def serve_logits(mesh, params, cfg, runs, recipe=None, broken=None):
    """``mesh_serve``, each run's result with ``logits``: every logits
    array the host sampled from (each prefill's, then each decode
    step's), in order. ``broken`` (``reorder`` or ``drop``) serves
    through :func:`_broken_gather` instead of the real gather."""
    host, gather = ShardedServeEngine._host_logits, Placement.gather_data
    out = []
    try:
        if broken is not None:
            Placement.gather_data = _broken_gather(broken)
        for run in runs:
            caught = []

            def capture(self, logits, prefill=False):
                arr = host(self, logits, prefill)
                caught.append(arr)
                return arr
            ShardedServeEngine._host_logits = capture
            (rec,) = mesh_serve(mesh, params, cfg, [run], recipe)
            out.append(dict(rec, logits=caught))
    finally:
        ShardedServeEngine._host_logits = host
        Placement.gather_data = gather
    return out


def moe_layer(mesh, layer, cfg, x, dtype, policy=None):
    """One MoE FFN (dropless, as decode runs it) on this rank's block of
    ``layer`` (one layer's weights, whole) under the decode recipe, in
    ``dtype`` but the f32 leaves (router, shared gate), on ``x`` whole on
    every rank: the rank's output, summed over ``model`` by the layer."""
    from repro_torch.dist.sharding import DECODE_RECIPE, shard_tree
    from repro_torch.models.model import F32_LEAVES
    from repro_torch.models.moe import moe_defs, moe_ffn

    axes = {k: d.axes for k, d in moe_defs(cfg).items()}
    p = shard_tree(layer, axes, DECODE_RECIPE, mesh, cfg,
                   dtype=lambda path: torch.float32 if any(
                       f"'{n}'" in path for n in F32_LEAVES) else dtype)
    pl = mesh.placement(cfg, DECODE_RECIPE)
    with torch.no_grad():
        out, _ = moe_ffn(p, x.to(mesh.device), cfg, dropless=True,
                         policy=policy, pl=pl)
    return dict(split=pl.moe_split, out=out.cpu())


JOBS = {"serve": mesh_serve, "train": mesh_train, "forward": mesh_forward,
        "logits": serve_logits, "moe_layer": moe_layer, "step": live_step,
        "pp": live_pp_step}


def run_jobs(mesh, jobs):
    return [JOBS[kind](mesh, *args) for kind, args in jobs]


def rank_sums(mesh, x):
    """This rank's coordinates and ``x`` summed over each axis."""
    return (mesh.rank, dict(mesh.coords),
            {a: mesh.all_reduce(x.clone(), a).tolist()
             for a in ("data", "model")})
