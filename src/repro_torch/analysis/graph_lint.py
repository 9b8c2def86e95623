"""Hot-path graph lint: trace what the card runs, execute nothing (the
port's counterpart of ``repro.analysis.jaxpr_lint``).

Per arch in the preset, the serving hot paths the reference's
``lint_arch`` traces — ``decode_step``, ``decode_step_paged`` (pool in
the runtime dtype), ``decode_step_paged@int8`` and ``prefill`` at every
``Scheduler.prefill_lengths`` bucket — run on ``meta`` tensors (abstract
parameters, a cache from ``cache_spec``/``paged_cache_spec``: nothing is
allocated) under a ``TorchDispatchMode``, :class:`_Graph`, that records
every aten op with its output shapes and dtypes. The policy is the
card's (``cuda``): each kernel wrapper, given ``meta`` tensors, runs its
checks and its own torch ops (the split-KV buffers, ``scale.float()``,
the sort by expert) and stands in for its launch
(``kernels.dispatch.meta_launch``), which the trace records as one
``kernel:<op>`` node, ``<op>`` the wrapper's key in the launch counters
(``moe_gemm`` for the grouped expert GEMM). So the trace is the op
sequence the card runs, kernels included, and its kernel nodes are the
launches one step makes. Each dispatch call is a ``dispatch:<op>`` node.
The walk is :mod:`repro_torch.analysis.liveness`'s storage walk; the
boolean-mask ``index``/``nonzero`` on ``meta`` take
``core.workload.torch_trace``'s upper bound.

* **trace stability** (``graph-trace-unstable``) — the step fails to
  trace; two traces of one signature give different op sequences (the
  ``str(jaxpr)`` comparison); or a cache leaf does not come back as the
  storage it went in as, at its shape, dtype and stride, or a buffer of
  a leaf's shape is allocated (``liveness.cache_in_place``: the port
  updates the cache in place, its counterpart of the reference's
  donation). A CUDA graph of the step needs all three.
* **host syncs** (``graph-host-sync``) — an op whose result the host
  must read: ``_local_scalar_dense`` (``.item()``, ``int()``,
  ``bool()``), ``equal``, an op whose output shape is data
  (``nonzero``, ``unique*``, ``masked_select``, ``bincount``, a boolean
  mask ``index``/``index_put``, ``repeat_interleave`` without
  ``output_size``) and a copy to the host (``.cpu()``, ``.tolist()``).
  Each is named by the innermost frame outside torch and this walk; on
  ``meta`` a placeholder result lets the trace go on, so one sync does
  not hide the next, and a sync that stops the trace is reported once.
* **dtype hygiene** (``graph-dtype-widen``) — no f64/c128 value, decode
  logits in the runtime dtype, every cache leaf after the step in its
  spec's dtype. f32 products (``mm``/``bmm``/``addmm``/``baddbmm``, as
  ``einsum`` lowers) under a bf16 runtime are reported at *info*
  severity (``graph-wide-dot``); kernel nodes are not dots.
* **quantized-pool hygiene** (``graph-int8-upcast``) — in the int8
  paged decode, no op may take a whole int8 K/V pool (a leaf, or one
  layer's) to a float output.
* **compile-count prediction** (``graph-compile-count``) —
  :func:`~repro_torch.analysis.prefill_compiles.predict_prefill_compiles`
  over every prompt length ``1..max_len`` within
  ``Scheduler.max_prefill_compiles()``.
"""
from __future__ import annotations

import dataclasses
import os
import sys
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.findings import Finding, Location
from repro_torch.analysis.liveness import (_Walk, _key, cache_in_place,
                                           leaf_signatures)
from repro_torch.analysis.prefill_compiles import predict_prefill_compiles
from repro_torch.analysis.registry import AnalysisContext, register_pass
from repro_torch.core.workload.torch_trace import _meta_index

aten = torch.ops.aten

#: Ops whose result the host reads.
_SCALAR_READS = {aten._local_scalar_dense.default, aten.equal.default}
#: Ops whose output shape is data.
_DATA_SHAPED = {aten.nonzero, aten.unique_dim, aten._unique, aten._unique2,
                aten.unique_consecutive, aten.unique_dim_consecutive,
                aten.masked_select, aten.bincount}
_INDEX_PUT = {aten.index_put, aten.index_put_, aten._index_put_impl_}
#: Matmul-family ops (``einsum`` lowers to ``bmm``).
_DOTS = {aten.mm, aten.bmm, aten.addmm, aten.baddbmm}
_WIDE = (torch.float64, torch.complex128)

_TORCH_DIR = os.path.dirname(torch.__file__)
_WALK_FILES = {os.path.abspath(__file__),
               os.path.abspath(sys.modules[_Walk.__module__].__file__)}


def _frame() -> str:
    """The innermost Python frame outside torch and this walk, as
    ``file:line (function)``, the file relative to the checkout."""
    from repro_torch.analysis.runner import repo_root
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if not (path.startswith(_TORCH_DIR) or path in _WALK_FILES
                or os.path.basename(path) == "contextlib.py"):
            rel = os.path.relpath(path, repo_root())
            return f"{path if rel.startswith('..') else rel}:" \
                   f"{f.f_lineno} ({f.f_code.co_name})"
        f = f.f_back
    return "<unknown>"


def _bool_index(indices) -> bool:
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in indices)


def _sync_kind(func, args, kwargs) -> Optional[str]:
    """What makes ``func`` a host sync, or None."""
    packet = func.overloadpacket
    if func in _SCALAR_READS:
        return f"{packet.__name__} (a value read by the host)"
    if packet in _DATA_SHAPED:
        return f"{packet.__name__} (output shape is data)"
    if packet is aten.repeat_interleave and \
            isinstance(args[0], torch.Tensor) and \
            kwargs.get("output_size") is None:
        return "repeat_interleave without output_size (output shape is data)"
    if packet is aten.index and _bool_index(args[1]):
        return "index by a boolean mask (output shape is data)"
    if packet in _INDEX_PUT and _bool_index(args[1]):
        return "index_put by a boolean mask (output shape is data)"
    if packet is aten._to_copy:
        dev = kwargs.get("device")
        if dev is not None and torch.device(dev).type == "cpu" \
                and args[0].device.type != "cpu":
            return "copy to the host (.cpu(), .tolist(), .numpy())"
    if packet is aten.copy_ and args[0].device.type == "cpu" \
            and isinstance(args[1], torch.Tensor) \
            and args[1].device.type != "cpu":
        return "copy to the host (copy_ into a CPU tensor)"
    return None


def _placeholder(func, args, kwargs):
    """A stand-in result for a sync on ``meta``, or ``NotImplemented``
    where none is made (the op then runs, and may stop the trace)."""
    packet = func.overloadpacket
    x = args[0] if args else None
    if not (isinstance(x, torch.Tensor) and x.device.type == "meta") and \
            not (packet is aten.copy_ and args[1].device.type == "meta"):
        return NotImplemented
    if func is aten._local_scalar_dense.default:
        return (False if x.dtype == torch.bool else
                0.0 if x.dtype.is_floating_point else 0)
    if func is aten.equal.default:
        return True
    if func is aten.nonzero.default or (packet is aten.index
                                        and _bool_index(args[1])):
        return _meta_index(func, args, kwargs)
    if packet is aten.masked_select:
        n = torch.broadcast_shapes(x.shape, args[1].shape)
        return torch.empty((int(torch.Size(n).numel()),), dtype=x.dtype,
                           device="meta")
    if packet is aten._to_copy:
        return torch.zeros(x.shape, dtype=kwargs.get("dtype") or x.dtype)
    if packet is aten.copy_:
        return x
    return NotImplemented


class _Graph(_Walk):
    """The storage walk of :mod:`repro_torch.analysis.liveness`, recording
    every op (name, output shapes and dtypes), the kernel nodes, the
    host syncs with their frames, f64 values, f32 products and what
    reads an int8 pool into a float output."""

    def __init__(self, arg_keys: Dict[int, int], pools=()) -> None:
        super().__init__(arg_keys)
        self.pools = {tuple(s) for s in pools}
        self.nodes: List[Tuple[str, Tuple]] = []
        self.kernels: Counter = Counter()
        self.syncs: Counter = Counter()          # (what, frame) -> n
        self.wide64: Counter = Counter()         # op -> n
        self.f32_dots = 0
        self.upcasts: Counter = Counter()        # (op, pool shape) -> n
        self.stopped: Optional[Tuple[str, str]] = None

    # -- the dispatch seam (kernels.dispatch.observe_kernels) ---------------
    def on_kernel(self, op, run, arrays, kwargs):
        self.nodes.append((f"dispatch:{op}", ()))
        return run()

    def on_meta_launch(self, name: str) -> None:
        self.nodes.append((f"kernel:{name}", ()))
        self.kernels[name] += 1

    # -- aten ops ------------------------------------------------------------
    def run(self, func, args, kwargs):
        sync = _sync_kind(func, args, kwargs)
        if sync is not None:
            where = (sync, _frame())
            self.syncs[where] += 1
            out = _placeholder(func, args, kwargs)
            if out is not NotImplemented:
                return self._record(func, args, out)
            try:
                return self._record(func, args, func(*args, **kwargs))
            except Exception:
                self.stopped = where
                raise
        return self._record(func, args, func(*args, **kwargs))

    def _record(self, func, args, out):
        outs = tuple((tuple(t.shape), t.dtype)
                     for t in tree_flatten(out)[0]
                     if isinstance(t, torch.Tensor))
        name = str(func)
        self.nodes.append((name, outs))
        packet = func.overloadpacket
        for _, dt in outs:
            if dt in _WIDE:
                self.wide64[name] += 1
        if packet in _DOTS and outs and outs[0][1] == torch.float32:
            self.f32_dots += 1
        if self.pools and any(dt.is_floating_point for _, dt in outs):
            for a in tree_flatten(args)[0]:
                if isinstance(a, torch.Tensor) and a.dtype == torch.int8 \
                        and tuple(a.shape) in self.pools:
                    self.upcasts[(name, tuple(a.shape))] += 1
        return out


def trace(fn: Callable, *args: Any, pools=(), grad: bool = False
          ) -> Tuple[_Graph, Any, Optional[Exception]]:
    """Run ``fn(*args)`` under :class:`_Graph` with the dispatch seam
    observed, autograd on when ``grad`` (a train step's backward is
    walked with its forward); returns the graph, fn's result (None if it
    raised) and the exception it raised, if any."""
    from repro_torch.kernels.dispatch import observe_kernels
    arg_keys = {}
    for t in tree_flatten(args)[0]:
        if isinstance(t, torch.Tensor):
            arg_keys[_key(t)] = t.untyped_storage().nbytes()
    g = _Graph(arg_keys, pools)
    try:
        with torch.set_grad_enabled(grad), \
                observe_kernels(g.on_kernel, g.on_meta_launch), g:
            return g, fn(*args), None
    except Exception as e:                       # noqa: BLE001
        return g, None, e


# ===========================================================================
# Findings of one trace
# ===========================================================================
def scan_graph(g: _Graph, *, label: str, rt_dtype: str) -> List[Finding]:
    """Host-sync, f64, wide-dot and whole-pool-upcast findings of one
    trace."""
    findings: List[Finding] = []
    for (what, frame), n in sorted(g.syncs.items()):
        stop = " (the trace stops here)" if g.stopped == (what, frame) \
            else ""
        findings.append(Finding(
            "graph-host-sync", "error", Location(symbol=label),
            f"{n}x host sync {what} at {frame} inside the hot path{stop} — "
            f"the host waits for the card every step, and the step cannot "
            f"be captured as a CUDA graph",
            "keep the value on the device (a static bound, a scatter-add "
            "count, output_size=)"))
    for name, n in sorted(g.wide64.items()):
        findings.append(Finding(
            "graph-dtype-widen", "error", Location(symbol=label),
            f"{n}x f64/c128 value produced by {name!r} in the hot path "
            f"(the card runs f64 at a fraction of its f32 rate; something "
            f"upcast past the runtime dtype)",
            "audit the literal/np-scalar that promoted to 64-bit"))
    if g.f32_dots and rt_dtype == "bfloat16":
        findings.append(Finding(
            "graph-wide-dot", "info", Location(symbol=label),
            f"{g.f32_dots} f32 products (mm/bmm/addmm/baddbmm) under a "
            f"{rt_dtype} runtime (softmax/SSM-state upcasts are intended; "
            f"watch this count)"))
    for (name, shape), n in sorted(g.upcasts.items()):
        findings.append(Finding(
            "graph-int8-upcast", "error", Location(symbol=label),
            f"{n}x {name} takes a full int8 KV pool {shape} to a float "
            f"output inside the decode step — the whole-pool upcast "
            f"defeats the quantized cache's byte budget",
            "gather the step's pages/rows first, dequantize only the "
            "block"))
    return findings


def _failed(g: _Graph, e: Exception, label: str, what: str
            ) -> List[Finding]:
    """A trace that raised: its syncs, and unless a sync stopped it, the
    failure itself."""
    found = [f for f in scan_graph(g, label=label, rt_dtype="")
             if f.rule_id == "graph-host-sync"]
    if g.stopped is None:
        found.append(Finding(
            "graph-trace-unstable", "error", Location(symbol=label),
            f"{what} fails to trace on meta: {type(e).__name__}: {e}"))
    return found


def check_step(fn: Callable, make_cache: Callable[[], Dict[str, Any]],
               params, tokens, spec, *, label: str, rt_dtype: torch.dtype,
               batch: int, pools=()) -> Tuple[List[Finding], Counter]:
    """Every rule over one decode step ``fn(params, cache, tokens) ->
    (cache, logits)``, traced twice on fresh caches from ``make_cache``;
    ``spec`` is the cache's ``{name: (shape, dtype)}``. Returns the
    findings and the step's kernel nodes."""
    cache = make_cache()
    before = leaf_signatures(cache)
    g, out, err = trace(fn, params, cache, tokens, pools=pools)
    if err is not None:
        return _failed(g, err, label, "the step"), g.kernels
    dt_name = str(rt_dtype).replace("torch.", "")
    findings = scan_graph(g, label=label, rt_dtype=dt_name)
    new_cache, logits = out
    moved, copies = cache_in_place(before, new_cache, g, batch)
    for k in moved:
        findings.append(Finding(
            "graph-trace-unstable", "error", Location(symbol=f"{label}/{k}"),
            f"cache leaf {k!r} does not come back as the storage it went "
            f"in as (storage, shape, dtype, stride {before[k][1:]}) — a "
            f"captured step would keep writing the old one",
            "update the leaf in place"))
    if copies:
        findings.append(Finding(
            "graph-trace-unstable", "error", Location(symbol=label),
            f"the step allocates buffers of cache leaf shapes {copies} — "
            f"it copies the cache instead of updating it",
            "write the new rows into the cache leaves in place"))
    for k, (_, dt) in sorted(spec.items()):
        t = new_cache.get(k)
        if isinstance(t, torch.Tensor) and t.dtype != dt:
            findings.append(Finding(
                "graph-dtype-widen", "error",
                Location(symbol=f"{label}/{k}"),
                f"cache leaf {k!r} comes back {t.dtype}, its spec says "
                f"{dt} — a widened cache costs its bytes again every step"))
    if logits.dtype != rt_dtype:
        findings.append(Finding(
            "graph-dtype-widen", "error", Location(symbol=label),
            f"decode logits are {logits.dtype}, runtime dtype is "
            f"{rt_dtype} — the unembed upcast leaks out of the step"))
    g2, _, err2 = trace(fn, params, make_cache(), tokens, pools=pools)
    if err2 is not None or g2.nodes != g.nodes:
        findings.append(Finding(
            "graph-trace-unstable", "error", Location(symbol=label),
            "re-tracing the identical signature yields a different op "
            f"sequence ({len(g.nodes)} vs {len(g2.nodes)} ops) — a "
            "captured graph would replay the wrong one",
            "remove trace-time randomness/id-dependence from the step"))
    return findings, g.kernels


# ===========================================================================
# Per-arch lint
# ===========================================================================
def _meta_tree(spec):
    return {k: torch.zeros(s, dtype=d, device="meta")
            for k, (s, d) in spec.items()}


def decode_case(cfg, rt, *, batch: int, max_len: int,
                page_size: Optional[int] = None):
    """One decode step as the engines run it under ``rt`` (its dtype,
    KV dtype and policy): ``(fn(params, cache, tokens), cache spec,
    int8 pool shapes)``, contiguous, or paged at ``page_size`` (a pool
    of ``batch * pages a slot + 1`` pages, page 0 the null page). The
    pool shapes are each int8 K/V leaf's and one layer's of it."""
    from repro_torch.models import model as M
    if page_size is None or cfg.family == "ssm":
        return ((lambda p, c, t: M.decode_step(p, cfg, c, t, rt)),
                M.cache_spec(cfg, batch, max_len, rt.dtype, rt.kv_dtype),
                [])
    W = M._cache_window(cfg, max_len)
    n_pages = batch * M.page_count(W, page_size) + 1
    spec = M.paged_cache_spec(cfg, batch, n_pages, page_size, max_len,
                              rt.dtype, rt.kv_dtype)
    pools = [s for k, (s, d) in spec.items()
             if k in ("kp", "vp") and d == torch.int8]
    return ((lambda p, c, t: M.decode_step_paged(
        p, cfg, c, t, rt, page_size=page_size, window=W)), spec,
        pools + [s[1:] for s in pools])


def decode_kernels(cfg, rt, *, batch: int, max_len: int,
                   page_size: Optional[int] = None) -> Counter:
    """The kernel nodes of one decode step (:func:`decode_case`) traced
    on ``meta``: the launches that step makes on the card."""
    from repro_torch.core.workload.torch_trace import _abstract_params
    rt = dataclasses.replace(rt, device="meta")
    fn, spec, _ = decode_case(cfg, rt, batch=batch, max_len=max_len,
                              page_size=page_size)
    tokens = torch.zeros((batch,), dtype=torch.int32, device="meta")
    g, _, err = trace(fn, _abstract_params(cfg, rt), _meta_tree(spec),
                      tokens)
    if err is not None:
        raise err
    return g.kernels


def lint_arch(arch: str, *, max_len: int, page_size: int, smoke: bool = True,
              batch: int = 2, policy=None,
              kernels: Optional[Dict[str, Counter]] = None
              ) -> List[Finding]:
    """Every rule over ``arch``'s hot paths (module docstring), under
    ``policy`` (default the card's, ``cuda``). ``kernels``, when given,
    receives each label's kernel nodes."""
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.core.workload.torch_trace import _abstract_params
    from repro_torch.kernels.dispatch import CUDA_POLICY
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import Scheduler

    cfg = get_arch(arch)
    cfg = smoke_config(cfg) if smoke else cfg
    rt = M.ModelRuntime(dtype="bfloat16", remat="none", attn_chunk=16,
                        moe_dropless=True, device="meta",
                        kernels=policy or CUDA_POLICY)
    params = _abstract_params(cfg, rt)
    tokens = torch.zeros((batch,), dtype=torch.int32, device="meta")
    findings: List[Finding] = []
    seen = kernels if kernels is not None else {}

    # contiguous (bf16), paged with the pool in the runtime dtype, as the
    # live engine has it, and paged over int8 pools
    cases = [(f"decode_step/{arch}", rt, None)]
    if cfg.family != "ssm":
        cases += [(f"decode_step_paged/{arch}", rt, page_size),
                  (f"decode_step_paged/{arch}@int8",
                   dataclasses.replace(rt, kv_dtype="int8"), page_size)]
    for label, case_rt, ps in cases:
        fn, spec, pools = decode_case(cfg, case_rt, batch=batch,
                                      max_len=max_len, page_size=ps)
        found, seen[label] = check_step(
            fn, lambda: _meta_tree(spec), params, tokens, spec, label=label,
            rt_dtype=rt.torch_dtype, batch=batch, pools=pools)
        findings.extend(found)

    # -- prefill per scheduler bucket ---------------------------------------
    sched = Scheduler(cfg, max_len)
    for L in sched.prefill_lengths:
        label = f"prefill/{arch}@L{L}"
        batch_in = {"tokens": torch.zeros((batch, L), dtype=torch.int32,
                                          device="meta")}
        lengths = (torch.full((batch,), L, dtype=torch.int32, device="meta")
                   if sched.pad_safe else None)
        g, _, err = trace(lambda p, b, lens: M.prefill(
            p, cfg, b, max_len, rt, lengths=lens), params, batch_in, lengths)
        seen[label] = g.kernels
        if err is not None:
            findings.extend(_failed(g, err, label, "the bucketed prefill"))
            continue
        findings.extend(scan_graph(g, label=label, rt_dtype=rt.dtype))

    # -- compile-count bound -------------------------------------------------
    predicted = predict_prefill_compiles(sched, range(1, max_len + 1))
    bound = sched.max_prefill_compiles()
    if predicted > bound:
        findings.append(Finding(
            "graph-compile-count", "error",
            Location(symbol=f"scheduler/{arch}"),
            f"serving every prompt length 1..{max_len} implies "
            f"{predicted} prefill shapes, above the scheduler's own "
            f"bound {bound} — plan() emits lengths outside "
            f"prefill_lengths",
            "make plan() land every prompt on a declared prefill length"))
    return findings


def lint_summary(arch: str, max_len: int, page_size: int,
                 smoke: bool) -> Dict[str, Any]:
    """:func:`lint_arch` under the card's policy as plain data (one
    worker's share of a preset run): the findings, each label's kernel
    nodes and the seconds it took."""
    import time
    t0 = time.perf_counter()
    kernels: Dict[str, Counter] = {}
    findings = lint_arch(arch, max_len=max_len, page_size=page_size,
                         smoke=smoke, kernels=kernels)
    return dict(findings=findings,
                kernels={k: dict(v) for k, v in kernels.items()},
                seconds=time.perf_counter() - t0)


@register_pass(
    "graph_lint",
    rules=("graph-compile-count", "graph-trace-unstable", "graph-host-sync",
           "graph-dtype-widen", "graph-wide-dot", "graph-int8-upcast"),
    description="meta-trace decode/paged-decode/bucketed-prefill under the "
                "cuda policy (bf16 + int8-KV pools), kernels as nodes; "
                "stability, compile-count, host-sync, dtype and "
                "whole-pool-dequant lint")
def run_pass(ctx: AnalysisContext) -> List[Finding]:
    findings: List[Finding] = []
    for arch in ctx.preset.archs:
        findings.extend(lint_arch(arch, max_len=ctx.preset.max_len,
                                  page_size=ctx.preset.page_size,
                                  smoke=ctx.preset.smoke))
    return findings
