"""PyTorch trace front-end: the port's own model lowered into the IR.

The port's counterpart of the reference's JAX-trace front-end
(``repro.core.workload.frontends.jax_trace``), in PyTorch's idiom.
:func:`trace_workload` runs the port's ``forward`` (train, prefill) or
``decode_step`` (decode) for one (arch x shape) cell under a
``TorchDispatchMode`` that sees every aten op the call makes:

* every ``mm``/``bmm``/``addmm``/``baddbmm``/``convolution`` is
  FLOP-counted from its shapes (2*K per output element);
* **parameter provenance**: the parameter leaves are seeded as weights
  and weight-ness propagates through view and cast ops (``unbind``,
  ``select``, ``t``, ``view``, ``_to_copy``, ...). A dot with exactly one
  weight operand is a ``matmul`` (weight bytes from the weight operand);
  a dot between two activations is ``attention`` (scores/PV, SSD chunk
  products);
* gathers from a weight of at least 1 MiB become ``embed`` ops (table
  bytes, 0 FLOPs);
* **kernel calls are counted at the dispatch seam**
  (``kernels.dispatch.observe_kernels``): each ``dispatch()`` call, and
  the fused expert GLU of the dropless MoE layer, is counted once as its
  plain (``torch``) version computes it, whatever the policy runs: the
  plain version runs on ``meta`` copies of the arguments, and what it
  computes is recorded. The call itself then runs uncounted (a CUDA
  kernel is invisible to an aten-level mode anyway). The grouped expert
  GEMM is counted from its shapes alone (one ``(K, N)`` product per row,
  every expert's weights read once): its plain version loops over the
  experts the data routes to.

By default the trace is **abstract**: parameters (at ``rt.dtype``, the
``F32_LEAVES`` in f32, as ``cast_params`` leaves them) and the decode
cache live on the ``meta`` device, so a full-width cell at a registry
shape allocates nothing. The one data-dependent shape on the way, the
kept slots of the MoE capacity path (a boolean-mask index), takes its
upper bound there (every slot kept); no counted op depends on it. Given
``params``, the same tracer runs the call on real tensors on their
device, under the runtime's own policy: that is how the trace is held
to what the card executes.

As in the reference, ops aggregate by ``(kind, K, N)`` across layers and
carry ``layer_idx=-1``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.workload.ir import Op, Workload, WorkloadError
from repro_torch.core.workload.lm import model_flops
from repro_torch.kernels.dispatch import implementations, observe_kernels

aten = torch.ops.aten

# Ops through which "is derived from a parameter leaf" propagates.
_VIEW_OPS = {
    aten.view, aten._unsafe_view, aten.reshape, aten._reshape_alias,
    aten.t, aten.transpose, aten.permute, aten.expand, aten.unbind,
    aten.select, aten.slice, aten.split, aten.split_with_sizes,
    aten.squeeze, aten.unsqueeze, aten.as_strided, aten._to_copy,
    aten.clone, aten.detach, aten.alias, aten.lift_fresh,
}
# Dots: the positions of (lhs, rhs) in the op's arguments.
_DOTS = {aten.mm: (0, 1), aten.addmm: (1, 2), aten.bmm: (0, 1),
         aten.baddbmm: (1, 2)}
# Gathers from a table (the first argument): the position of the index.
_GATHERS = {aten.index: 1, aten.embedding: 1, aten.index_select: 2}

# Gathers from a weight table at least this large count as embedding ops.
_EMBED_MIN_BYTES = 1 << 20

# Elementwise ops that evaluate a transcendental function per output
# element (XLA's ``transcendentals`` count).
_TRANSCENDENTAL = {
    aten.exp, aten.exp2, aten.expm1, aten.log, aten.log1p, aten.log2,
    aten.tanh, aten.sigmoid, aten.rsqrt, aten.sqrt, aten.sin, aten.cos,
    aten.erf, aten.pow, aten.silu, aten.gelu, aten.softplus,
    aten._softmax, aten._log_softmax,
}


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


class _TraceState:
    """Accumulates raw op records + trace statistics during the call."""

    def __init__(self) -> None:
        self.records: List[Dict[str, Any]] = []
        self.eqns = 0
        self.transcendentals = 0

    def add(self, kind: str, K: int, N: int, flops: float,
            weight_bytes: float, act_in: float, act_out: float,
            weight_dtype: Optional[str] = None,
            act_dtype: Optional[str] = None) -> None:
        self.records.append(dict(kind=kind, K=int(K), N=int(N),
                                 flops=flops, weight_bytes=weight_bytes,
                                 act_in=act_in, act_out=act_out, count=1,
                                 weight_dtype=weight_dtype,
                                 act_dtype=act_dtype))


def _is_meta(t: Any) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == "meta"


def _meta_index(func, args, kwargs):
    """``aten.index`` / ``aten.nonzero`` of a boolean mask on ``meta``,
    which has no meta kernel (the count of true entries is data): the
    upper bound, every entry true."""
    if func is aten.nonzero.default:
        x = args[0]
        return torch.empty((x.numel(), x.dim()), dtype=torch.long,
                           device="meta")
    src, indices = args[0], []
    for i in args[1]:
        if i is not None and i.dtype == torch.bool:
            indices += [torch.empty((i.numel(),), dtype=torch.long,
                                    device="meta")] * i.dim()
        else:
            indices.append(i)
    return func(src, indices, **kwargs)


class _Tracer(TorchDispatchMode):
    """The dispatch mode that records dots, weight gathers and kernel
    calls, and tracks which tensors derive from a parameter leaf."""

    def __init__(self) -> None:
        super().__init__()
        self.st = _TraceState()
        self.weights = WeakTensorKeyDictionary()
        self.quiet = 0                  # > 0: run ops unrecorded

    def is_weight(self, t: Any) -> bool:
        return isinstance(t, torch.Tensor) and t in self.weights

    def mark(self, t: torch.Tensor) -> None:
        self.weights[t] = True

    # -- aten ops ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.quiet:
            return func(*args, **kwargs)
        self.st.eqns += 1
        if _is_meta(args[0] if args else None) and (
                func is aten.nonzero.default
                or (func is aten.index.Tensor and any(
                    i is not None and i.dtype == torch.bool
                    for i in args[1]))):
            out = _meta_index(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in _TRANSCENDENTAL and isinstance(out, torch.Tensor):
            self.st.transcendentals += out.numel()
        if packet in _DOTS:
            self._dot(*_DOTS[packet], args, out)
        elif packet is aten.convolution:
            self._conv(args, out)
        elif packet in _GATHERS:
            src = args[0]
            if self.is_weight(src) and _nbytes(src) >= _EMBED_MIN_BYTES:
                idx = args[_GATHERS[packet]]
                idx = idx[0] if isinstance(idx, (list, tuple)) else idx
                self.st.add("embed", 0, int(src.shape[-1]), 0.0,
                            weight_bytes=_nbytes(src),
                            act_in=_nbytes(idx), act_out=_nbytes(out),
                            weight_dtype=_dtype_name(src.dtype),
                            act_dtype=_dtype_name(out.dtype))
        elif packet in _VIEW_OPS and any(
                self.is_weight(a) for a in tree_flatten(args)[0]):
            for o in tree_flatten(out)[0]:
                if isinstance(o, torch.Tensor):
                    self.mark(o)
        return out

    def _dot(self, li: int, ri: int, args, out) -> None:
        lhs, rhs = args[li], args[ri]
        K = int(lhs.shape[-1])
        flops = 2.0 * K * out.numel()
        lhs_w, rhs_w = self.is_weight(lhs), self.is_weight(rhs)
        if lhs_w != rhs_w:                      # weight x activation
            w, a = (lhs, rhs) if lhs_w else (rhs, lhs)
            # the weight's dim that is neither contracted nor batch
            N = int(w.shape[-2] if lhs_w else w.shape[-1])
            self.st.add("matmul", K, N, flops, weight_bytes=_nbytes(w),
                        act_in=_nbytes(a), act_out=_nbytes(out),
                        weight_dtype=_dtype_name(w.dtype),
                        act_dtype=_dtype_name(out.dtype))
        else:                                   # activation x activation
            self.st.add("attention", K, int(out.shape[-1]), flops,
                        weight_bytes=0.0,
                        act_in=_nbytes(lhs) + _nbytes(rhs),
                        act_out=_nbytes(out),
                        act_dtype=_dtype_name(out.dtype))

    def _conv(self, args, out) -> None:
        x, w = args[0], args[1]
        cout = int(w.shape[0])
        k_per_out = w.numel() / max(cout, 1)     # r*s*cin/groups
        w_w = self.is_weight(w)
        self.st.add("conv", int(k_per_out), cout,
                    2.0 * out.numel() * k_per_out,
                    weight_bytes=_nbytes(w) if w_w else 0.0,
                    act_in=_nbytes(x), act_out=_nbytes(out),
                    weight_dtype=_dtype_name(w.dtype) if w_w else None,
                    act_dtype=_dtype_name(out.dtype))

    # -- kernel calls (kernels.dispatch.observe_kernels) --------------------
    def on_kernel(self, op: str, run: Callable[[], Any], arrays: Tuple,
                  kwargs: Dict[str, Any]) -> Any:
        tensors = [a for a in arrays if isinstance(a, torch.Tensor)]
        abstract = all(t.device.type == "meta" for t in tensors)
        if op in _GROUPED:
            out_shape = _GROUPED[op](self, *arrays)
            if abstract:
                return arrays[0].new_empty(out_shape)
        else:
            # the plain version, on meta copies, recorded
            meta = tuple(self._meta_like(a) for a in arrays)
            out = implementations(op)["torch"](*meta, **kwargs)
            if abstract:
                return out
        self.quiet += 1
        try:
            return run()
        finally:
            self.quiet -= 1

    def _meta_like(self, a: Any) -> Any:
        if not isinstance(a, torch.Tensor) or a.device.type == "meta":
            return a
        self.quiet += 1
        try:
            m = torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                    device="meta")
        finally:
            self.quiet -= 1
        if self.is_weight(a):
            self.mark(m)
        return m

    def grouped_gemm(self, x: torch.Tensor, w: torch.Tensor) -> None:
        """One ``moe_gemm``: every row of ``x`` times its expert's (K, N)
        slice of ``w`` (E, K, N); every expert's weights read once."""
        T, K, N = int(x.shape[0]), int(w.shape[-2]), int(w.shape[-1])
        self.st.add("matmul", K, N, 2.0 * T * K * N,
                    weight_bytes=_nbytes(w), act_in=_nbytes(x),
                    act_out=float(T * N * x.element_size()),
                    weight_dtype=_dtype_name(w.dtype),
                    act_dtype=_dtype_name(x.dtype))


def _moe_gemm(tr: _Tracer, x, w, expert_of_row, **_) -> Tuple[int, int]:
    tr.grouped_gemm(x, w)
    return (x.shape[0], w.shape[-1])


def _moe_gemm_glu(tr: _Tracer, x, w_gate, w_up, w_down, expert_of_row,
                  **_) -> Tuple[int, int]:
    """The three products of ``kernels.moe_gemm.moe_gemm_glu``, as the
    ``torch`` impl's three ``moe_gemm`` dispatches compute them."""
    tr.grouped_gemm(x, w_gate)
    tr.grouped_gemm(x, w_up)
    tr.grouped_gemm(x.new_empty((x.shape[0], w_gate.shape[-1]),
                                device="meta"), w_down)
    return (x.shape[0], w_down.shape[-1])


#: Kernel calls counted from shapes alone, each returning its out shape.
_GROUPED = {"moe_gemm": _moe_gemm, "moe_gemm_glu": _moe_gemm_glu}


# ---------------------------------------------------------------------------
# Record -> Op aggregation (the reference's, over the port's configs)
# ---------------------------------------------------------------------------
def _axis_hint(cfg: ModelConfig, K: int, N: int
               ) -> Tuple[Optional[str], int]:
    """Best-effort sharding-axis hint for a traced weight of shape
    (K, N) — lets the TPU model shard a *traced* workload sensibly."""
    d, hd = cfg.d_model, cfg.head_dim
    heads_dims = {cfg.n_heads * hd, cfg.n_kv_heads * hd,
                  (cfg.n_heads + 2 * cfg.n_kv_heads) * hd}
    ssm_dims = set()
    if cfg.ssm is not None:
        di = cfg.ssm.d_inner(d)
        ssm_dims = {di, 2 * di + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
                    + cfg.ssm.n_heads(d)}
    for wd in (N, K):
        if wd == cfg.vocab_size:
            return "vocab", wd
        if cfg.d_ff and wd == cfg.d_ff:
            return "ffn", wd
        if wd in ssm_dims:
            return "ssm_inner", wd
        if wd in heads_dims and wd != d:
            return "heads", cfg.n_heads
    return None, N


def _aggregate(records: List[Dict[str, Any]], cfg: ModelConfig
               ) -> Tuple[Op, ...]:
    """Merge raw records by (kind, K, N) into stable, ordered Op rows."""
    merged: Dict[Tuple[str, int, int], Dict[str, Any]] = {}
    order: List[Tuple[str, int, int]] = []
    for r in records:
        key = (r["kind"], r["K"], r["N"])
        if key not in merged:
            merged[key] = dict(r)
            order.append(key)
        else:
            m = merged[key]
            for f in ("flops", "weight_bytes", "act_in", "act_out"):
                m[f] += r[f]
            m["count"] += 1
    ops = []
    for i, key in enumerate(order):
        r = merged[key]
        kind, K, N = key
        axis, width = (None, N)
        if kind in ("matmul", "embed"):
            axis, width = _axis_hint(cfg, K, N)
        name = f"{kind}.{K}x{N}"
        if r["count"] > 1:
            name += f"(x{r['count']})"
        ops.append(Op(name=name, kind=kind, flops=r["flops"],
                      weight_bytes=r["weight_bytes"],
                      act_in_bytes=r["act_in"], act_out_bytes=r["act_out"],
                      layer_idx=-1, weight_axis=axis, width=width,
                      weight_dtype=r.get("weight_dtype"),
                      act_dtype=r.get("act_dtype")))
    return tuple(ops)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------
def _abstract_params(cfg: ModelConfig, rt) -> Dict[str, Any]:
    """The parameter tree on ``meta``, each leaf in the dtype
    ``cast_params`` gives it under ``rt``."""
    from repro_torch.models.model import F32_LEAVES, param_defs

    def walk(defs, path=()):
        if isinstance(defs, dict):
            return {k: walk(v, path + (k,)) for k, v in defs.items()}
        keep = any(p in F32_LEAVES for p in path)
        return torch.empty(defs.shape, device="meta",
                           dtype=torch.float32 if keep else rt.torch_dtype)

    return walk(param_defs(cfg))


def trace_workload(cfg: Union[ModelConfig, str],
                   shape: Union[ShapeConfig, str],
                   kv_len: Optional[int] = None,
                   rt=None, *, params=None) -> Workload:
    """Trace the port's model on one (arch x shape) cell into the IR.

    train/prefill trace :func:`repro_torch.models.forward`; decode traces
    :func:`repro_torch.models.decode_step` against a cache of ``kv_len``
    (default ``shape.kv_len`` or ``seq_len``) slots. ``rt`` defaults to
    the reference's trace runtime: ``remat='none'``, ``attn_chunk >=
    seq_len`` and the plain (``torch``) policy. ``params`` (real tensors,
    as ``cast_params`` leaves them) runs the call on their device under
    ``rt``'s policy; without them the trace is abstract (``meta``).
    """
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.kernels.dispatch import TORCH_POLICY
    from repro_torch.models.model import (ModelRuntime, cache_spec,
                                          decode_step, forward, torch_dtype)

    if isinstance(cfg, str):
        cfg = get_arch(cfg)
    if isinstance(shape, str):
        shape = get_shape(shape)
    kv = kv_len if kv_len is not None else \
        (getattr(shape, "kv_len", None) or shape.seq_len)
    B, S = shape.global_batch, shape.seq_len
    dev = torch.device("meta") if params is None else \
        tree_flatten(params)[0][0].device
    rt = rt or ModelRuntime(dtype=cfg.dtype, remat="none",
                            attn_chunk=max(S, 16), kernels=TORCH_POLICY)
    if params is None:
        params = _abstract_params(cfg, rt)
    if shape.kind == "decode":
        cache = {k: torch.zeros(s, dtype=d, device=dev)
                 for k, (s, d) in cache_spec(cfg, B, kv, rt.dtype,
                                             rt.kv_dtype).items()}
        tokens = torch.zeros((B,), dtype=torch.int32, device=dev)

        def fn():
            return decode_step(params, cfg, cache, tokens, rt)

        traced_pass = "decode_step"
    else:
        if cfg.frontend == "token":
            batch = {"tokens": torch.zeros((B, S), dtype=torch.int32,
                                           device=dev)}
        else:                      # a stubbed patch or frame front-end
            batch = {"embeds": torch.zeros(
                (B, S, cfg.d_model), dtype=torch_dtype(cfg.dtype),
                device=dev)}

        def fn():
            return forward(params, cfg, batch, rt)

        traced_pass = "forward"

    leaves = tree_flatten(params)[0]
    tracer = _Tracer()
    for leaf in leaves:
        tracer.mark(leaf)
    try:
        with torch.no_grad(), observe_kernels(tracer.on_kernel), tracer:
            fn()
    except Exception as e:                   # noqa: BLE001
        raise WorkloadError(
            f"torch trace of {cfg.name}/{shape.name} failed: "
            f"{type(e).__name__}: {e}") from e

    ops = _aggregate(tracer.st.records, cfg)
    if not ops:
        raise WorkloadError(
            f"torch trace of {cfg.name}/{shape.name} produced no "
            f"countable ops — the dispatch mode saw no dots/convs")
    param_bytes = sum(math.prod(t.shape) * t.element_size() for t in leaves)
    return Workload(
        name=f"trace:{cfg.name}/{shape.name}",
        frontend="torch_trace",
        ops=ops,
        kind=shape.kind,
        meta={
            "arch": cfg.name, "shape": shape.name, "pass": traced_pass,
            "seq_len": S, "global_batch": B, "kv_len": kv,
            "param_bytes": int(param_bytes),
            "trace_eqns": int(tracer.st.eqns),
            "trace_scans": 0,
            "while_loops": 0,
            "raw_records": len(tracer.st.records),
        },
        model_flops_hint=model_flops(cfg, shape),
    )


# ---------------------------------------------------------------------------
# Traced-vs-analytic comparison (the standing validation `diff` runs)
# ---------------------------------------------------------------------------
def diff_workloads(analytic: Workload, traced: Workload) -> Dict[str, Any]:
    """Cross-check a traced workload against its analytic twin.

    The load-bearing number is ``matmul_ratio`` — traced / analytic
    weight-fed dot FLOPs (matmul+router+conv vs matmul), which must
    agree closely because both sides count the same GEMMs. Attention
    and scan FLOPs are reported but expected to diverge where the
    executable computes masked/padded work the analytic profile skips
    (causal halving, MoE capacity padding) — that gap is a *finding*,
    not an error.
    """
    a_kinds = analytic.flops_by_kind()
    t_kinds = traced.flops_by_kind()
    a_mm = sum(a_kinds.get(k, 0.0) for k in ("matmul", "router", "conv"))
    t_mm = sum(t_kinds.get(k, 0.0) for k in ("matmul", "conv"))
    a_act = sum(a_kinds.get(k, 0.0) for k in ("attention", "scan"))
    t_act = t_kinds.get("attention", 0.0)
    a_wb = analytic.total_weight_bytes()
    t_wb = traced.total_weight_bytes()

    def ratio(t: float, a: float) -> float:
        return t / a if a > 0 else (1.0 if t == 0 else float("inf"))

    rows = []
    for o in traced.ops:
        if o.kind not in ("matmul", "conv"):
            continue
        rows.append({"op": o.name, "kind": o.kind,
                     "gflop": o.flops / 1e9,
                     "weight_mb": o.weight_bytes / 1e6,
                     "axis": o.weight_axis or "-"})
    return {
        "analytic": analytic.name,
        "traced": traced.name,
        "matmul_flops_analytic": a_mm,
        "matmul_flops_traced": t_mm,
        "matmul_ratio": ratio(t_mm, a_mm),
        "activation_flops_analytic": a_act,
        "activation_flops_traced": t_act,
        "activation_ratio": ratio(t_act, a_act),
        "weight_bytes_analytic": a_wb,
        "weight_bytes_traced": t_wb,
        "weight_bytes_ratio": ratio(t_wb, a_wb),
        "while_loops": traced.meta.get("while_loops", 0),
        "traced_matmul_ops": rows,
    }
