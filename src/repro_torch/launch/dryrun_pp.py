"""Pipeline-parallel dry-run of the port (counterpart of
``repro.launch.dryrun_pp``): the paper's paradigm-1 *spatial* mode.

Mesh (stage=4, data=8, model=8) = 256 cards: each stage holds a
contiguous quarter of the layer stack (its own dedicated pipeline
stage), microbatches stream through the stages by ring shifts
(``dist.pipeline.pipeline_apply``, ``Mesh.shift``), and the whole train
step, the forward and then the pipelined backward, is traced for one
rank on ``meta`` under the card's kernel policy and priced with
``core.hardware.H100_SXM``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_pp --arch chatglm3-6b

What a rank computes, as the reference's ``shard_map`` does: the
embedding of its rows of the ``(n_micro, mb, seq)`` tokens (``mb``
split over ``data``), its stage's block of the stacked layers through
the GPipe schedule, the final norm, the head and the cross entropy, and
the gradient of every leaf, under the dry-run cells' runtime
(``launch.lowering.cell_runtime``: the reference's bf16, ``remat="full"``,
``attn_chunk=512``). The block stack is split over ``stage``;
every other leaf is whole on every rank, over ``model`` too (the
reference's ``P()``), so the ``model`` ranks repeat one another's work.
The step's collectives: a ``collective-permute`` per tick and the
backward's per tick (the shift; gloo runs it as a gather and a pick),
the sum over ``stage`` that replicates the pipeline's output, the
embedding's gradient summed over ``stage`` (only stage 0 feeds the
pipeline) and every gradient summed over ``data``, the loss averaged
there.

Where the port departs: ``trace_s`` replaces ``compile_s``; each block
runs under ``remat="full"`` (the port's training form: a block's inputs
kept, the rest recomputed in the backward), where the reference's
scanned stage keeps what XLA keeps; the memory block is the storage
walk's (``launch.lowering.memory_of``), the cost the trace front-end's
(``launch.lowering.cost_of``), the collectives the rank's records,
every tick counted where XLA counts a scanned body once.

The artifact has the reference's keys (``memory_gb_per_chip``,
``flops_per_chip``, ``collective_permute_gb``, ``collectives_total_gb``,
rounded as the reference rounds them) and the raw bytes behind them,
the bubble fraction ``(S - 1) / (M + S - 1)`` and the roofline terms.
It is written under ``<root>/dryrun/pp/`` (``artifacts.pp_dir``).

Importing this module has no side effects.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.launch.presets import FULL, Preset

#: The reference's data and model axes of the stage mesh.
DATA, MODEL = 8, 8


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """The GPipe schedule's idle share: ``(S - 1) / (M + S - 1)``."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pp_params(cfg, mesh, n_stages: int, params=None) -> Dict[str, Any]:
    """This rank's f32 parameters on ``mesh.device``: every leaf whole,
    the block stack's ``stage_split`` block of this rank's stage (leaves
    ``(1, L / S, ...)``). ``params`` (the whole tree) gives the values;
    without it the leaves are on ``meta``."""
    from repro_torch.dist.pipeline import stage_split
    from repro_torch.launch.lowering import _whole_meta_params
    from repro_torch.tree import tree_map
    if params is None:
        params = _whole_meta_params(cfg, lambda p: torch.float32)
    s = mesh.coords["stage"]

    def place(t):
        return torch.empty(t.shape, dtype=torch.float32,
                           device=mesh.device).copy_(t)

    out = {k: tree_map(place, v) for k, v in params.items() if k != "blocks"}
    out["blocks"] = tree_map(
        lambda w: place(stage_split(w, n_stages)[s:s + 1]), params["blocks"])
    return out


def pp_batch(mesh, n_micro: int, mb: int, seq: int, tokens=None,
             labels=None) -> Dict[str, torch.Tensor]:
    """This rank's rows of the ``(n_micro, mb, seq)`` int32 tokens and
    labels: ``mb`` split over ``data``; zeros when not given."""
    D = mesh.sizes.get("data", 1)
    if mb % D:
        raise ValueError(f"microbatch {mb} does not split over data={D}")
    per, d = mb // D, mesh.coords.get("data", 0)
    out = {}
    for name, t in (("tokens", tokens), ("labels", labels)):
        if t is None:
            out[name] = torch.zeros((n_micro, per, seq), dtype=torch.int32,
                                    device=mesh.device)
        else:
            # a copy of the rows alone (a view would hold the whole batch)
            rows = torch.as_tensor(t).narrow(1, d * per, per)
            out[name] = torch.empty(rows.shape, dtype=rows.dtype,
                                    device=mesh.device).copy_(rows)
    return out


def make_pp_step(cfg, rt, mesh, n_stages: int):
    """``step(params, batch) -> (loss, grads)`` on this rank of ``mesh``
    (``stage``, ``data``, ``model``): :func:`pp_params`' blocks and
    :func:`pp_batch`'s rows. ``loss`` is the global batch's mean cross
    entropy and ``grads`` each leaf's gradient of it, both equal on
    every rank that holds the leaf."""
    from repro_torch.dist.pipeline import pipeline_apply
    from repro_torch.models import layers as L
    from repro_torch.models.model import (_default_positions, _layers,
                                          _lookup, _remat, _unembed,
                                          attn_block)
    from repro_torch.train.loop import sum_in_buckets
    from repro_torch.tree import tree_leaves, tree_map
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not split into "
                         f"{n_stages} stages")
    pol = rt.kernel_policy()
    D = mesh.sizes.get("data", 1)

    def step(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        leaves = tree_map(lambda t: t.detach().requires_grad_(), params)
        x = _lookup(leaves, tokens, rt)                     # (M, mb, S, d)
        # only stage 0 feeds the pipeline: the embedding's gradient is
        # summed over ``stage``
        x = mesh.enter(x, "stage")
        _, mb, S, _ = x.shape
        rope = L.rope_tables(_default_positions(cfg, mb, S, x.device), cfg)
        layer = _remat(lambda p, h: attn_block(p, h, rope, cfg, rt)[0], rt)

        def stage_fn(local, h):
            for p in _layers(local):
                h = layer(p, h)
            return h

        y = pipeline_apply(stage_fn, mesh, n_stages)(leaves["blocks"], x)
        y = L.norm(y, leaves["final_norm"], cfg.norm, policy=pol)
        loss = L.cross_entropy(_unembed(leaves, cfg, y), labels)
        flat = tree_leaves(leaves)
        grads = list(torch.autograd.grad(loss, flat, allow_unused=True,
                                         materialize_grads=True))
        loss = loss.detach()
        if D > 1:
            sum_in_buckets(grads, mesh, "data")
            grads = [g / D for g in grads]
            loss = mesh.all_reduce(loss, "data") / D
        it = iter(grads)
        return loss, tree_map(lambda _: next(it), leaves)

    return step


def pp_case(cfg, mesh, n_stages: int, n_micro: int, mb: int, seq: int,
            rt, params=None, tokens=None, labels=None):
    """The rank's PP train step as a ``launch.lowering.StepCase``."""
    from repro_torch.launch.lowering import StepCase, _nbytes
    rt = dataclasses.replace(rt, device=str(mesh.device))
    p = pp_params(cfg, mesh, n_stages, params)
    batch = pp_batch(mesh, n_micro, mb, seq, tokens, labels)
    return StepCase(make_pp_step(cfg, rt, mesh, n_stages), (p, batch),
                    _nbytes((p, batch)), True, p)


def trace_pp_rank(cfg, shape, axes, rank: int, n_micro: int, mb: int,
                  seq: int, rt) -> Dict[str, Any]:
    """One rank of a stage mesh ``shape`` over ``axes``, traced on
    ``meta`` (``launch.lowering.trace_rank``'s keys)."""
    from repro_torch.analysis.graph_lint import trace
    from repro_torch.launch.lowering import memory_of
    from repro_torch.launch.mesh import DryMesh
    mesh = DryMesh(shape, axes, rank)
    case = pp_case(cfg, mesh, mesh.sizes["stage"], n_micro, mb, seq, rt)
    g, out, err = trace(case.fn, *case.args, grad=True)
    if err is not None:
        raise err
    mem = memory_of(case, g, out)
    del out
    return dict(rank=rank, memory=mem, records=list(mesh.records),
                counts=mesh.counts(), axis_counts=mesh.axis_counts(),
                kernels=dict(g.kernels))


def trace_pp_ranks(cfg, shape, axes, n_micro: int, mb: int, seq: int,
                   rt) -> list:
    """Every rank's :func:`trace_pp_rank`, in rank order (each stage's
    graph is its own: the masks differ)."""
    import math
    return [trace_pp_rank(cfg, shape, axes, r, n_micro, mb, seq, rt)
            for r in range(math.prod(shape))]


def live_pp_step(mesh, cfg, rt, n_micro: int, mb: int, seq: int, params,
                 tokens=None, labels=None,
                 return_grads: bool = True) -> Dict[str, Any]:
    """The PP step once on a live rank of ``mesh`` (every rank calls
    it; ``params`` the whole f32 tree, ``tokens``/``labels`` the whole
    ``(n_micro, mb, seq)`` batch, zeros when None), what
    :func:`trace_pp_rank` is held to (``launch.lowering.live_step``'s
    keys), the loss and, with ``return_grads``, this rank's gradients,
    on the CPU."""
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
    base = torch.cuda.memory_allocated(mesh.device) if cuda else 0
    case = pp_case(cfg, mesh, mesh.sizes["stage"], n_micro, mb, seq, rt,
                   params, tokens, labels)
    if cuda:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    mesh.collectives.reset()
    loss, grads = case.fn(*case.args)
    if cuda:
        torch.cuda.synchronize(mesh.device)
    rec = dict(rank=mesh.rank, counts=mesh.collectives.as_dict(),
               axis_counts=mesh.collectives.axes_dict(),
               argument_bytes=int(case.argument_bytes),
               loss=float(loss))
    if cuda:
        rec["peak_bytes"] = int(torch.cuda.max_memory_allocated(mesh.device)
                                - base)
    if return_grads:
        from repro_torch.tree import tree_map
        rec["grads"] = tree_map(lambda g: g.float().cpu(), grads)
    return rec


def lower_pp(arch: str = "chatglm3-6b", n_stages: int = 4,
             n_micro: int = 8, mb: int = 32, seq: int = 4096,
             preset: Preset = FULL) -> Dict[str, Any]:
    """One rank of ``DryMesh((n_stages, 8, 8), ("stage", "data",
    "model"))`` through the PP train step on ``meta``; returns the
    artifact (module docstring). ``preset`` only sizes the arch
    (``Preset.arch``)."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.roofline import (collective_link_bytes,
                                           dominant_term, roofline_terms)
    from repro_torch.launch.lowering import cell_runtime, cost_of
    from repro_torch.launch.mesh import DryMesh
    cfg = preset.arch(arch)
    shape, axes = (n_stages, DATA, MODEL), ("stage", "data", "model")
    rt = cell_runtime()         # the reference's bf16, remat "full", 512
    t0 = time.time()
    top = trace_pp_rank(cfg, shape, axes, 0, n_micro, mb, seq, rt)
    cost = cost_of(pp_case(cfg, DryMesh(shape, axes, 0), n_stages, n_micro,
                           mb, seq, rt))
    t_trace = time.time() - t0
    sizes = dict(zip(axes, shape))
    coll = collective_link_bytes(top["records"], sizes, H100_SXM)
    mem = top["memory"]
    terms = roofline_terms(cost["flops"], cost["bytes_accessed"],
                           coll["by_link"], H100_SXM)
    return {
        "arch": arch, "mode": "pipeline-parallel",
        "mesh": f"(stage={n_stages}, data={DATA}, model={MODEL})",
        "n_micro": n_micro, "status": "OK",
        "trace_s": round(t_trace, 2),
        "memory_gb_per_chip": {
            "argument": round(mem["argument_bytes"] / 2**30, 2),
            "temp": round(mem["temp_bytes"] / 2**30, 2),
        },
        "flops_per_chip": float(cost["flops"]),
        "collective_permute_gb": round(coll["collective-permute"] / 2**30, 2),
        "collectives_total_gb": round(coll["total"] / 2**30, 2),
        "preset": preset.name, "mesh_axes": sizes, "microbatch": mb,
        "seq_len": seq, "rank": top["rank"], "memory": mem, "cost": cost,
        "collectives": coll, "collective_calls": top["counts"],
        "kernels": top["kernels"],
        "bubble_fraction": bubble_fraction(n_stages, n_micro),
        "roofline": {**terms, "dominant": dominant_term(terms),
                     "step_time_bound_s": max(terms.values())},
    }


def write_pp(art: Dict[str, Any], out_dir: Optional[str] = None) -> str:
    """Write ``art`` as ``<arch>__pp__stage<S>.json`` under ``out_dir``
    (default ``artifacts.pp_dir()``); returns the path."""
    from repro_torch.artifacts import pp_dir
    out_dir = out_dir or pp_dir()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{art['arch']}__pp__stage"
                                 f"{art['mesh_axes']['stage']}.json")
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--stages", type=int, default=4)
    ap.add_argument("--micro", type=int, default=8)
    ap.add_argument("--preset", default="full", choices=("full", "ci"),
                    help="the arch's size: full width, or ci's smoke "
                         "width")
    ap.add_argument("--out", default=None,
                    help="artifact directory (default: "
                         "$REPRO_TORCH_ARTIFACT_DIR/dryrun/pp or "
                         "./artifacts/torch/dryrun/pp)")
    args = ap.parse_args(argv)
    from repro_torch.launch.presets import get_preset
    art = lower_pp(args.arch, args.stages, args.micro,
                   preset=get_preset(args.preset))
    write_pp(art, args.out)
    print(json.dumps(art, indent=1))


if __name__ == "__main__":
    main()
