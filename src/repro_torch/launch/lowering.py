"""Per-cell dry-run pipeline of the port (counterpart of
``repro.launch.lowering``): what one card of a mesh far larger than the
host would hold, compute and send per step, with nothing allocated.

For one (architecture x input-shape x mesh) cell, :func:`lower_cell`:

  1. picks the reference launcher's recipe
     (``dist.sharding.default_recipe``) and microbatches
     (:func:`default_microbatches`);
  2. builds one rank's inputs on ``meta`` from the full-width leaves
     through the rank's ``Placement`` (:func:`input_specs`,
     :func:`abstract_train_state`, :func:`abstract_decode_cache`);
  3. runs the cell's step (``train.loop.make_train_step``,
     ``models.prefill``, ``models.decode_step``) on a
     :class:`~repro_torch.launch.mesh.DryMesh` rank under the card's
     kernel policy: each kernel wrapper takes its ``meta`` branch, each
     collective is a record. Two traces, nothing launched:

     * the storage walk of ``analysis.liveness`` (the graph lint's
       ``trace``, kernels as nodes) gives the peak, the kernel launches,
       the host syncs and the collective records;
     * the trace front-end's tracer (``core.workload.torch_trace``)
       counts the FLOPs and the bytes of the products, each kernel's
       operands and outputs (its FLOPs its plain version's) and the
       transcendentals, a train step's backward included;

  4. returns the reference's artifact keys (the sweep in
     ``launch.dryrun`` writes one JSON per cell).

Where the reference departs:

* it lowers at full depth: XLA miscounts loop bodies, so the reference
  lerps two probe depths (``cost_probe``); a trace sees every op, so
  ``trace_s`` replaces ``lower_s`` and ``compile_s``;
* ``memory`` is the walk's: ``argument_bytes`` the rank's parameters
  (train: its state), cache and batch rows, ``alias_bytes`` the cache or
  train state the step updates in place (the reference donates them),
  ``output_bytes`` what the step returns, ``peak_bytes`` the walk's peak
  with every argument held through the step, as the caller holds it on
  the card, and ``temp_bytes`` the peak beyond the arguments and the fresh
  outputs; the norm scales, router and SSM leaves stay f32 in a bf16
  runtime, as the port holds them;
* ``cost`` counts the products (dots, the embedding gathers), the
  kernels (FLOPs of their plain versions, bytes of their operands and
  outputs) and the transcendentals, not XLA's elementwise bytes; ``collectives`` come from the rank's records, ring-scaled and
  priced per link (``core.roofline``), where XLA picks its own;
* a prefill cell gives each data rank its rows of the batch (the
  reference's input sharding; the sharded engine's prefill takes the
  whole batch on every rank);
* it traces one rank for each distinct set of local shapes and reports
  the largest peak. MoE routing on ``meta`` is the plan's balanced
  routing (``kernels.moe_gemm.balanced_routing``), the capacity path
  its upper bound (every slot kept).

Importing this module has no side effects.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs import shape_skip_reason
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.dist import sharding as S
from repro_torch.dist.sharding import Placement, Recipe, axis_rules, use_mesh
from repro_torch.launch.presets import FULL, MeshSpec, Preset


# ---------------------------------------------------------------------------
# Microbatches and the runtime (the reference launcher's)
# ---------------------------------------------------------------------------
def default_microbatches(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Gradient-accumulation factor so the activations fit: target
    <= ~64k global tokens per microbatch for wide models."""
    if shape.kind != "train":
        return 1
    tokens = shape.seq_len * shape.global_batch
    target = 65536 if cfg.d_model >= 4096 else 131072
    m = max(1, tokens // target)
    while shape.global_batch % m:
        m -= 1
    return m


#: The runtime knobs every cell is traced at: the reference's baseline
#: (its ``lower_cell`` defaults), recorded in each artifact.
REMAT, ATTN_CHUNK, MOE_CHUNK = "full", 512, 0


def cell_runtime():
    """A cell's runtime: bf16 under the card's policy at
    :data:`REMAT`, :data:`ATTN_CHUNK` and :data:`MOE_CHUNK` (the
    reference's ``ModelRuntime(dtype='bfloat16', ...)``); a step takes
    its mesh's device (:func:`step_case`)."""
    from repro_torch.kernels.dispatch import CUDA_POLICY
    from repro_torch.models.model import ModelRuntime
    return ModelRuntime(dtype="bfloat16", remat=REMAT, attn_chunk=ATTN_CHUNK,
                        moe_chunk=MOE_CHUNK, kernels=CUDA_POLICY)


# ---------------------------------------------------------------------------
# One rank's inputs
# ---------------------------------------------------------------------------
def batch_rows(B: int, sizes: Dict[str, int]) -> int:
    """A rank's rows of a global batch of ``B``: split over (pod, data)
    where that divides it, else whole (the reference's sanitized
    spec)."""
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    return B // dp if B % dp == 0 else B


def _batch(cfg: ModelConfig, B: int, S_: int, kind: str, dtype, device,
           expand: bool = False) -> Dict[str, torch.Tensor]:
    """A batch of ``B`` rows: ``tokens`` (B, S) int32 or ``embeds`` (B, S,
    d) for a patch or frame front end, and ``labels`` in training; with
    ``expand``, stride-0 views of one element (no storage to speak of)."""
    def leaf(shape, dt):
        if expand:
            return torch.zeros((), dtype=dt, device=device).expand(shape)
        return torch.zeros(shape, dtype=dt, device=device)

    out = {}
    if cfg.frontend == "token":
        out["tokens"] = leaf((B, S_), torch.int32)
    else:
        out["embeds"] = leaf((B, S_, cfg.d_model), dtype)
    if kind == "train":
        out["labels"] = leaf((B, S_), torch.int32)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The rank's step inputs on ``mesh.device``: a train step's global
    batch (each rank takes its rows inside the step: stride-0 host views,
    as the card's host holds it, one element of storage each), a
    prefill's rows, a decode step's tokens of this rank's slots."""
    kind = shape.kind
    B, S_ = shape.global_batch, shape.seq_len
    sizes = S.mesh_sizes(mesh)
    if kind == "train":
        return _batch(cfg, B, S_, kind, dtype, "cpu", expand=True)
    if kind == "prefill":
        return _batch(cfg, batch_rows(B, sizes), S_, kind, dtype,
                      mesh.device)
    return {"tokens": torch.zeros((batch_rows(B, sizes),), dtype=torch.int32,
                                  device=mesh.device)}


def _whole_meta_params(cfg: ModelConfig, dtype_of: Callable) -> Dict:
    from repro_torch.models.model import param_defs

    def walk(defs, path=()):
        if isinstance(defs, dict):
            return {k: walk(v, path + (k,)) for k, v in defs.items()}
        return torch.empty(defs.shape, device="meta", dtype=dtype_of(path))

    return walk(param_defs(cfg))


def abstract_params(cfg: ModelConfig, recipe: Recipe, mesh, rt,
                    params=None) -> Dict:
    """The rank's parameter blocks on ``mesh.device`` as the sharded
    engines hold them (``serve.sharded``): each leaf at ``rt``'s dtype,
    the ``F32_LEAVES`` in f32. ``params`` (the whole tree) gives the
    values; without it the full-width leaves are on ``meta``."""
    from repro_torch.models.model import axes_tree, leaf_dtype
    if params is None:
        params = _whole_meta_params(cfg, lambda p: leaf_dtype(p, rt))
    return S.shard_tree(params, axes_tree(cfg), recipe, mesh, cfg,
                        dtype=lambda path: leaf_dtype(path, rt))


def abstract_train_state(cfg: ModelConfig, recipe: Recipe, mesh,
                         params=None) -> Dict:
    """The rank's train state: its blocks of the f32 masters and AdamW's
    two moments and int32 step (``train.loop.shard_state``). ``params``
    (the whole f32 tree) gives the values; else ``meta``."""
    from repro_torch.train.loop import shard_state
    if params is None:
        params = _whole_meta_params(cfg, lambda p: torch.float32)
    return shard_state(params, cfg, recipe, mesh)


def abstract_decode_cache(cfg: ModelConfig, shape: ShapeConfig,
                          recipe: Recipe, mesh, rt) -> Dict:
    """The rank's block of the contiguous decode cache of
    ``shape.global_batch`` slots of ``shape.kv_len`` (or ``seq_len``)
    tokens, zeros on ``mesh.device``."""
    from repro_torch.models.model import cache_spec
    max_len = getattr(shape, "kv_len", None) or shape.seq_len
    with use_mesh(mesh), axis_rules(recipe):
        spec = cache_spec(cfg, shape.global_batch, max_len, rt.dtype,
                          rt.kv_dtype)
    return {k: torch.zeros(s, dtype=d, device=mesh.device)
            for k, (s, d) in spec.items()}


def _nbytes(tree) -> int:
    seen, total = set(), 0
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            key = t.untyped_storage()._cdata
            if key not in seen:
                seen.add(key)
                total += t.untyped_storage().nbytes()
    return total


@dataclasses.dataclass
class StepCase:
    """One rank's step: ``fn(*args)`` and what the artifact reads of it.
    ``argument_bytes`` counts the rank's parameters or train state, its
    cache and its rows of the batch; ``grad`` whether the step takes a
    gradient; ``weights`` the parameter leaves the cost trace seeds."""

    fn: Callable
    args: Tuple
    argument_bytes: int
    grad: bool
    weights: Any


def step_case(cfg: ModelConfig, shape: ShapeConfig, mesh, recipe: Recipe,
              rt, *, microbatches: int = 1, params=None) -> StepCase:
    """The cell's step on ``mesh`` (a ``DryMesh`` rank, or a live rank
    given the whole ``params``) under ``recipe`` and ``rt``."""
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.train.loop import TrainConfig, make_train_step
    from repro_torch.train.optim import AdamWConfig

    sizes = S.mesh_sizes(mesh)
    rt = dataclasses.replace(rt, device=str(mesh.device))
    if shape.kind == "train":
        state = abstract_train_state(cfg, recipe, mesh, params)
        batch = input_specs(cfg, shape, mesh, dtype=rt.torch_dtype)
        tc = TrainConfig(opt=AdamWConfig(), microbatches=microbatches)
        step = make_train_step(cfg, rt, tc, recipe)

        def fn(state, batch):
            with use_mesh(mesh):
                return step(state, batch)

        rows = batch_rows(shape.global_batch, sizes)
        batch_b = sum(t.numel() * t.element_size() * rows
                      // shape.global_batch for t in batch.values())
        return StepCase(fn, (state, batch), _nbytes(state) + batch_b, True,
                        state["params"])
    p = abstract_params(cfg, recipe, mesh, rt, params)
    if shape.kind == "prefill":
        batch = input_specs(cfg, shape, mesh, dtype=rt.torch_dtype)

        def fn(p, batch):
            with use_mesh(mesh), axis_rules(recipe):
                return prefill(p, cfg, batch, shape.seq_len, rt)

        return StepCase(fn, (p, batch), _nbytes((p, batch)), False, p)
    cache = abstract_decode_cache(cfg, shape, recipe, mesh, rt)
    tokens = torch.zeros(cache["pos"].shape, dtype=torch.int32,
                         device=mesh.device)

    def fn(p, cache, tokens):
        with use_mesh(mesh), axis_rules(recipe):
            return decode_step(p, cfg, cache, tokens, rt)

    return StepCase(fn, (p, cache, tokens), _nbytes((p, cache, tokens)),
                    False, p)


# ---------------------------------------------------------------------------
# The traces
# ---------------------------------------------------------------------------
def memory_of(case: StepCase, g, out) -> Dict[str, int]:
    """The artifact's ``memory`` block from a walk (module docstring)."""
    args = {t.untyped_storage()._cdata for t in tree_flatten(case.args)[0]
            if isinstance(t, torch.Tensor)}
    outs, alias, fresh = set(), 0, 0
    for t in tree_flatten(out)[0]:
        if not isinstance(t, torch.Tensor) or t.device.type != "meta":
            continue
        key = t.untyped_storage()._cdata
        if key in outs:
            continue
        outs.add(key)
        if key in args:
            alias += t.untyped_storage().nbytes()
        else:
            fresh += t.untyped_storage().nbytes()
    peak = g.peak(held=True)
    return {
        "argument_bytes": int(case.argument_bytes),
        "output_bytes": int(alias + fresh),
        "temp_bytes": int(max(0, peak - case.argument_bytes - fresh)),
        "alias_bytes": int(alias),
        "peak_bytes": int(peak),
    }


def _tensor_bytes(tree) -> float:
    return float(sum(t.numel() * t.element_size()
                     for t in tree_flatten(tree)[0]
                     if isinstance(t, torch.Tensor)))


def cost_of(case: StepCase) -> Dict[str, float]:
    """FLOPs, bytes and transcendentals of one step, as the trace
    front-end's tracer counts them (``torch_trace._Tracer``: the products,
    the kernels' plain versions for their FLOPs). A kernel's bytes are
    what it reads and writes, its operands and outputs at their own
    dtypes, not its plain version's (which may widen them: the decode
    attention's plain version reads K and V in f32); the grouped expert
    GEMMs are priced so already."""
    from repro_torch.core.workload.torch_trace import _GROUPED, _Tracer
    from repro_torch.kernels.dispatch import observe_kernels
    tracer = _Tracer()
    for leaf in tree_flatten(case.weights)[0]:
        if isinstance(leaf, torch.Tensor):
            tracer.mark(leaf)
    recs = tracer.st.records
    plain, kernel_bytes = set(), 0.0

    def on_kernel(op, run, arrays, kwargs):
        nonlocal kernel_bytes
        n = len(recs)
        out = tracer.on_kernel(op, run, arrays, kwargs)
        if op not in _GROUPED:
            plain.update(range(n, len(recs)))
            kernel_bytes += _tensor_bytes((arrays, out))
        return out

    with torch.set_grad_enabled(case.grad), observe_kernels(on_kernel), \
            tracer:
        case.fn(*case.args)
    return {
        "flops": float(sum(r["flops"] for r in recs)),
        "bytes_accessed": kernel_bytes + float(sum(
            r["weight_bytes"] + r["act_in"] + r["act_out"]
            for i, r in enumerate(recs) if i not in plain)),
        "transcendentals": float(tracer.st.transcendentals),
    }


def rank_signature(cfg: ModelConfig, recipe: Recipe, sizes: Dict[str, int],
                   coords: Dict[str, int], shape: ShapeConfig):
    """The local shapes of every parameter and cache leaf on the rank at
    ``coords``: ranks with one signature trace alike."""
    from repro_torch.models.model import (CACHE_AXES, axes_tree, cache_spec,
                                          param_defs)
    pl = Placement(cfg, recipe, sizes, coords)
    out = []

    def walk(defs, axes):
        if isinstance(defs, dict):
            for k in sorted(defs):
                walk(defs[k], axes[k])
            return
        out.append(pl.local_shape(axes or (None,) * len(defs.shape),
                                  defs.shape))

    walk(param_defs(cfg), axes_tree(cfg))
    if shape.kind == "decode":
        spec = cache_spec(cfg, shape.global_batch,
                          getattr(shape, "kv_len", None) or shape.seq_len)
        out += [pl.local_shape(CACHE_AXES[k], s) for k, (s, _) in
                sorted(spec.items())]
    return tuple(out)


def trace_rank(cfg: ModelConfig, shape: ShapeConfig, spec: MeshSpec,
               rank: int, recipe: Recipe, rt,
               microbatches: int = 1) -> Dict[str, Any]:
    """One rank's dry step: memory, collective records (and their
    counts), kernel nodes and host syncs."""
    from repro_torch.analysis.graph_lint import trace
    from repro_torch.launch.mesh import DryMesh
    mesh = DryMesh(spec.shape, spec.axes, rank)
    case = step_case(cfg, shape, mesh, recipe, rt, microbatches=microbatches)
    g, out, err = trace(case.fn, *case.args, grad=case.grad)
    if err is not None:
        raise err
    mem = memory_of(case, g, out)
    del out
    rec = dict(rank=rank, memory=mem, records=list(mesh.records),
               counts=mesh.counts(), kernels=dict(g.kernels),
               syncs=[dict(what=w, frame=f, n=n)
                      for (w, f), n in sorted(g.syncs.items())])
    return rec


def trace_ranks(cfg: ModelConfig, shape: ShapeConfig, spec: MeshSpec,
                recipe: Recipe, rt, microbatches: int = 1
                ) -> List[Dict[str, Any]]:
    """Every rank's :func:`trace_rank`, in rank order: one trace per
    distinct :func:`rank_signature`, shared by the ranks that have it
    (its ``rank`` is the first of them)."""
    import itertools
    sizes = spec.axis_sizes()
    traced: Dict[Any, Dict[str, Any]] = {}
    out = []
    for r, c in enumerate(itertools.product(*(range(n)
                                              for n in spec.shape))):
        sig = rank_signature(cfg, recipe, sizes, dict(zip(spec.axes, c)),
                             shape)
        if sig not in traced:
            traced[sig] = trace_rank(cfg, shape, spec, r, recipe, rt,
                                     microbatches)
        out.append(traced[sig])
    return out


def unique_traces(traces: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The distinct traces of :func:`trace_ranks`, by first rank."""
    return list({t["rank"]: t for t in traces}.values())


def rank_cost(cfg: ModelConfig, shape: ShapeConfig, spec: MeshSpec,
              rank: int, recipe: Recipe, rt,
              microbatches: int = 1) -> Dict[str, float]:
    """One rank's cost block (:func:`cost_of`)."""
    from repro_torch.launch.mesh import DryMesh
    mesh = DryMesh(spec.shape, spec.axes, rank)
    return cost_of(step_case(cfg, shape, mesh, recipe, rt,
                             microbatches=microbatches))


def live_step(mesh, cfg: ModelConfig, shape: ShapeConfig, recipe: Recipe,
              rt, params, microbatches: int = 1) -> Dict[str, Any]:
    """The cell's step once on a live rank of ``mesh`` (every rank calls
    it), from ``params`` (the whole tree: f32 masters for training), what
    a dry trace of the same rank is held to: the rank's collective
    counts (``Mesh.collectives``, set to 0 just before the step), its
    argument bytes and, on a card, its peak over the step (memory
    allocated before the inputs were built subtracted)."""
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
    base = torch.cuda.memory_allocated(mesh.device) if cuda else 0
    case = step_case(cfg, shape, mesh, recipe, rt, microbatches=microbatches,
                     params=params)
    if cuda:
        torch.cuda.synchronize(mesh.device)
        torch.cuda.reset_peak_memory_stats(mesh.device)
    mesh.collectives.reset()
    with torch.set_grad_enabled(case.grad):
        out = case.fn(*case.args)
    if cuda:
        torch.cuda.synchronize(mesh.device)
    rec = dict(rank=mesh.rank, counts=mesh.collectives.as_dict(),
               argument_bytes=int(case.argument_bytes))
    if cuda:
        rec["peak_bytes"] = int(torch.cuda.max_memory_allocated(mesh.device)
                                - base)
    del out, case
    return rec


# ---------------------------------------------------------------------------
# The cell
# ---------------------------------------------------------------------------
def lower_cell(arch: str, shape_name: str, mesh_spec: MeshSpec,
               mesh_name: str, preset: Preset = FULL) -> Dict[str, Any]:
    """Trace one cell at ``preset`` scale on ``mesh_spec`` under the
    reference launcher's recipe and microbatches; returns the artifact
    dict (the reference's keys; module docstring)."""
    from repro_torch.core.hardware import H100_SXM
    from repro_torch.core.roofline import (collective_link_bytes,
                                           roofline_report)
    from repro_torch.core.workload import lm_workload

    cfg = preset.arch(arch)
    shape = preset.shape(shape_name)
    sizes = mesh_spec.axis_sizes()
    ident = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
             "preset": preset.name, "mesh_axes": sizes}
    skip = shape_skip_reason(cfg, shape)
    if skip:
        return {**ident, "status": "SKIP", "reason": skip}
    if "pod" in sizes:
        raise NotImplementedError(
            "the (pod, data, model) mesh is not ported: the port's Mesh and "
            "recipes have the data and model axes only (ROADMAP.md, Queue 1, "
            "the next slice: the pod axis)")
    recipe = S.default_recipe(cfg, shape.kind, sizes["model"])
    m = default_microbatches(cfg, shape)
    rt = cell_runtime()

    t0 = time.time()
    traced = unique_traces(trace_ranks(cfg, shape, mesh_spec, recipe, rt,
                                       m))
    ranks = [t["rank"] for t in traced]
    top = max(traced, key=lambda t: t["memory"]["peak_bytes"])
    top["cost"] = rank_cost(cfg, shape, mesh_spec, top["rank"], recipe, rt,
                            m)
    t_trace = time.time() - t0

    art = {
        **ident,
        "status": "OK",
        "variant": "baseline",
        "recipe": recipe.name,
        "microbatches": m,
        "remat": REMAT,
        "attn_chunk": ATTN_CHUNK,
        "moe_chunk": MOE_CHUNK,
        "devices": int(mesh_spec.devices),
        "trace_s": round(t_trace, 2),
        "rank": top["rank"],
        "ranks_traced": ranks,
        "memory": top["memory"],
        "cost": top["cost"],
        "collectives": collective_link_bytes(top["records"], sizes,
                                             H100_SXM),
        "collective_calls": top["counts"],
        "kernels": top["kernels"],
        "host_syncs": top["syncs"],
    }
    wl = lm_workload(cfg, shape)
    art["workload"] = {
        "name": wl.name, "frontend": wl.frontend, "ops": len(wl),
        "analytic_flops": wl.total_ops(),
        "model_flops": wl.model_flops(),
        "weight_bytes": wl.total_weight_bytes(),
    }
    art["roofline"] = roofline_report(wl, art, H100_SXM)
    return art
