"""Kernel dispatch: the seam between the models and the kernels.

Mirror of the reference ``repro.kernels.dispatch``: each compute hot
spot is a registered op (same names as the reference ``KERNEL_OPS``)
with pluggable implementations,

* ``torch`` — the plain PyTorch version (the counterpart of ``xla``);
* ``cuda`` — the hand-written Hopper kernel (the counterpart of
  ``pallas``). Its wrapper runs the plain version for CPU tensors only;
  for CUDA tensors it launches the kernel or raises.

A :class:`KernelPolicy` names the implementation per op, plus optional
tuning parameters merged over the call-site keyword arguments (a policy
built from a tuner calibration carries its winning parameters). The
port's default is ``cuda`` (the reference defaults to ``xla``), so the
card runs the kernels unless a caller asks for ``KernelPolicy.torch()``.

Gradients: the kernels are forward-only, so when a gradient is needed a
non-``torch`` implementation runs inside a ``torch.autograd.Function``
whose backward is the autograd of the op's ``torch`` implementation
(kernel forward, reference backward), as the reference's
``_ref_backward`` does. Without one (serving) it is called directly.

Every call through this seam (each :func:`dispatch`, and the fused
calls of :func:`fused_call`) passes an installed observer
(:func:`observe_kernels`) first: the trace front-end
(``repro_torch.core.workload.torch_trace``) counts each kernel call
there from its arguments' shapes, whatever the policy.

Each ``cuda`` implementation carries its kernel's launch plan
(``fn.launch_plan(*arrays, **kwargs)``, a ``kernels.plan.KernelPlan``)
and the library's (``fn.library_plan``), taken from its arguments'
shapes (:func:`planned`); the static kernel validator
(``repro_torch.analysis.kernel_validator``) checks the plans, at
registration where an implementation gives an ``example``.
"""
from __future__ import annotations

import contextlib
import importlib
import os
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

#: Op names, in dispatch-table order (identical to the reference).
KERNEL_OPS = ("prefill_attention", "decode_attention",
              "paged_decode_attention", "rmsnorm", "ssd_scan", "moe_gemm",
              "quant_matmul", "quant_decode_attention",
              "quant_paged_decode_attention")

#: One default eps for every RMSNorm implementation; the call-site value
#: threads through dispatch into whichever implementation runs.
RMSNORM_EPS = 1e-6

ParamsTuple = Tuple[Tuple[str, Tuple[Tuple[str, Any], ...]], ...]


@dataclass(frozen=True)
class KernelPolicy:
    """Per-op implementation choice (``torch`` or ``cuda``) and tuning
    parameters. Frozen and hashable: ``params`` are nested tuples, kept
    in op-sorted order so equal policies compare equal."""

    prefill_attention: str = "cuda"
    decode_attention: str = "cuda"
    paged_decode_attention: str = "cuda"
    rmsnorm: str = "cuda"
    ssd_scan: str = "cuda"
    moe_gemm: str = "cuda"
    quant_matmul: str = "cuda"
    quant_decode_attention: str = "cuda"
    quant_paged_decode_attention: str = "cuda"
    params: ParamsTuple = ()

    @classmethod
    def cuda(cls) -> "KernelPolicy":
        return cls()

    @classmethod
    def torch(cls) -> "KernelPolicy":
        return cls(**{op: "torch" for op in KERNEL_OPS})

    @classmethod
    def from_flag(cls, use_kernels: bool) -> "KernelPolicy":
        """The ``ModelRuntime.use_kernels`` bool, mapped onto a policy."""
        return cls.cuda() if use_kernels else cls.torch()

    @classmethod
    def from_calibration(cls, calib: Dict[str, Any]) -> "KernelPolicy":
        """A policy from a calibration payload's ``policy`` block (written
        by ``repro_torch.kernels.tune``): the winning implementation and
        its parameters per op. An op the block does not name keeps the
        port's default, ``cuda``."""
        choices = calib.get("policy", {})
        kw = {op: choices.get(op, {}).get("impl", "cuda")
              for op in KERNEL_OPS}
        params = tuple(
            (op, tuple(sorted(choices[op].get("params", {}).items())))
            for op in sorted(KERNEL_OPS)
            if choices.get(op, {}).get("params"))
        return cls(params=params, **kw)

    def impl_for(self, op: str) -> str:
        if op not in KERNEL_OPS:
            raise KeyError(f"unknown kernel op {op!r}; "
                           f"registered: {KERNEL_OPS}")
        return getattr(self, op)

    def params_for(self, op: str) -> Dict[str, Any]:
        for name, kv in self.params:
            if name == op:
                return dict(kv)
        return {}

    def with_params(self, op: str, **kw: Any) -> "KernelPolicy":
        merged = {**self.params_for(op), **kw}
        by_op = dict(self.params)
        by_op[op] = tuple(sorted(merged.items()))
        return replace(self, params=tuple(sorted(by_op.items())))

    def describe(self) -> str:
        return " ".join(f"{op}={self.impl_for(op)}" for op in KERNEL_OPS)


CUDA_POLICY = KernelPolicy.cuda()
TORCH_POLICY = KernelPolicy.torch()


def resolve_policy(policy: Optional[KernelPolicy]) -> KernelPolicy:
    return CUDA_POLICY if policy is None else policy


# ===========================================================================
# Dispatch table
# ===========================================================================
_TABLE: Dict[str, Dict[str, Callable]] = {op: {} for op in KERNEL_OPS}


class KernelValidationError(ValueError):
    """An implementation failed the static kernel validator at
    registration time; the message carries the findings verbatim."""


def _validate_on_register() -> bool:
    """Opt-out flag, read at registration time so tests can flip it."""
    return os.environ.get("REPRO_TORCH_VALIDATE_KERNELS", "1") != "0"


def register_impl(op: str, impl: str,
                  example: Optional[Callable] = None,
                  validate: Optional[bool] = None,
                  ) -> Callable[[Callable], Callable]:
    """Decorator: register ``fn`` as implementation ``impl`` of ``op``.

    ``example`` opts the implementation into registration-time static
    validation (``repro_torch.analysis.kernel_validator``): a no-arg
    callable returning ``(args, kwargs)``, operand tensors on ``meta``
    plus call-site kwargs, at which the impl's launch plan is checked
    (coverage, races, shared memory; the checks against the ``torch``
    implementation run in the tune-preset sweep). Error findings
    reject the registration with a :class:`KernelValidationError` naming
    the rule. ``validate=False`` (or ``REPRO_TORCH_VALIDATE_KERNELS=0``)
    opts out, for tests that seed deliberately broken impls.
    """
    if op not in _TABLE:
        raise KeyError(f"unknown kernel op {op!r}; registered: {KERNEL_OPS}")

    def deco(fn: Callable) -> Callable:
        run = _validate_on_register() if validate is None else validate
        if run and example is not None and impl != "torch":
            from repro_torch.analysis.kernel_validator import validate_impl
            args, kwargs = example()
            findings = validate_impl(op, impl, fn, args, dict(kwargs),
                                     ref=_TABLE[op].get("torch"),
                                     label=f"{op}/{impl}@register",
                                     plan_only=True)
            errors = [f for f in findings if f.severity == "error"]
            if errors:
                raise KernelValidationError(
                    f"refusing to register {op}/{impl}: "
                    + "; ".join(f.describe() for f in errors))
        _TABLE[op][impl] = fn
        return fn

    return deco


def planned(module: str, plan: str, shapes: Callable,
            library: Optional[str] = None) -> Callable[[Callable], Callable]:
    """Decorator: attach the launch plan of the kernel ``fn`` runs, as
    ``fn.launch_plan(*arrays, **kwargs)`` and ``fn.library_plan(...)``:
    ``shapes(*arrays, **kwargs)`` gives the ``(args, kwargs)`` of
    ``module.plan`` and of the library's twin ``module.library`` (default
    ``library_plan``). Goes under :func:`register_impl`, so that its
    validation sees the plan."""
    def call(name: str) -> Callable:
        def run(*arrays: Any, **kwargs: Any) -> Any:
            args, kw = shapes(*arrays, **kwargs)
            return getattr(importlib.import_module(module), name)(*args,
                                                                  **kw)
        return run

    def deco(fn: Callable) -> Callable:
        fn.launch_plan = call(plan)
        fn.library_plan = call(library or "library_plan")
        return fn

    return deco


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _host_array(t: Any) -> Any:
    """A tensor's values on the host, or None on ``meta`` (no data)."""
    if t.device.type == "meta":
        return None
    return t.detach().cpu().numpy()


def implementations(op: str) -> Dict[str, Callable]:
    """The live implementation mapping for one op (tests may wrap an
    entry to prove a path is taken)."""
    if op not in _TABLE:
        raise KeyError(f"unknown kernel op {op!r}; registered: {KERNEL_OPS}")
    return _TABLE[op]


class _RefBackward(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd of the ``torch`` impl at
    the same inputs and keyword arguments, for the inputs that need a
    gradient. A tuple result (the SSD scan's ``(y, h)``) takes one
    cotangent per element."""

    @staticmethod
    def forward(ctx, fn, ref, kwargs, *arrays):
        ctx.ref, ctx.kwargs = ref, kwargs
        ctx.save_for_backward(*arrays)
        return fn(*arrays, **kwargs)

    @staticmethod
    def backward(ctx, *cts):
        need = ctx.needs_input_grad[3:]
        arrays = [a.detach().requires_grad_(n)
                  for a, n in zip(ctx.saved_tensors, need)]
        diff = [a for a in arrays if a.requires_grad]
        with torch.enable_grad():
            out = ctx.ref(*arrays, **ctx.kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            grads = iter(torch.autograd.grad(outs, diff, cts,
                                             allow_unused=True))
        return (None, None, None) + tuple(
            next(grads) if a.requires_grad else None for a in arrays)


def ref_backward(fn: Callable, ref: Callable, *arrays: Any,
                 **kwargs: Any) -> Any:
    """``fn(*arrays, **kwargs)``, differentiated as ``ref`` is: when a
    gradient is needed, ``fn`` runs inside :class:`_RefBackward`, whose
    backward is the autograd of ``ref`` at the same inputs (kernel
    forward, reference backward). Without one (serving) ``fn`` is called
    directly."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in arrays):
        return _RefBackward.apply(fn, ref, kwargs, *arrays)
    return fn(*arrays, **kwargs)


#: The installed kernel-call observer, or None (see :func:`observe_kernels`).
_OBSERVER: Optional[Callable] = None
#: The installed recorder of launches on ``meta``, or None.
_ON_META_LAUNCH: Optional[Callable[[str], None]] = None


@contextlib.contextmanager
def observe_kernels(observer: Optional[Callable],
                    on_meta_launch: Optional[Callable[[str], None]] = None,
                    ) -> Iterator[None]:
    """Install ``observer`` for the block. Each kernel call then returns
    ``observer(op, run, arrays, kwargs)`` in place of ``run()``, where
    ``run`` makes the call as it stands (the policy's implementation on
    the caller's arguments); the observer decides whether to call it.
    ``on_meta_launch(name)`` is called where a kernel wrapper given
    ``meta`` tensors stands in for its launch (:func:`meta_launch`)."""
    global _OBSERVER, _ON_META_LAUNCH
    prev = _OBSERVER, _ON_META_LAUNCH
    _OBSERVER, _ON_META_LAUNCH = observer, on_meta_launch
    try:
        yield
    finally:
        _OBSERVER, _ON_META_LAUNCH = prev


def meta_launch(name: str, out: Any) -> Any:
    """A kernel wrapper's ``meta`` branch, at the point where it would
    launch on the card: its checks have run and its buffers are
    allocated, on ``meta``. Nothing launches and nothing is computed;
    the installed recorder counts one launch of ``name`` (the wrapper's
    key in the launch counters) and ``out``, the empty outputs, is
    returned."""
    if _ON_META_LAUNCH is not None:
        _ON_META_LAUNCH(name)
    return out


def _observed(op: str, run: Callable[[], Any], arrays: Tuple,
              kwargs: Dict[str, Any]) -> Any:
    if _OBSERVER is None:
        return run()
    return _OBSERVER(op, run, arrays, kwargs)


def fused_call(op: str, fn: Callable, ref: Callable, *arrays: Any,
               **kwargs: Any) -> Any:
    """A kernel entry that fuses several dispatch ops (``moe_gemm_glu``:
    three ``moe_gemm``), named ``op`` for the observer and differentiated
    as ``ref`` (:func:`ref_backward`)."""
    return _observed(op, lambda: ref_backward(fn, ref, *arrays, **kwargs),
                     arrays, kwargs)


def dispatch(op: str, policy: Optional[KernelPolicy], *arrays: Any,
             **kwargs: Any) -> Any:
    """Route one hot-spot call through the policy's implementation.

    ``kwargs`` are call-site parameters (eps, causal, window, chunk, and
    the reference's tile sizes ``block_k``/``pages_per_block``); the
    policy's parameters for the op are merged over them. Implementations
    accept ``**_`` so a parameter meaningful only to the other
    implementation is ignored rather than rejected. A non-``torch``
    implementation is differentiated as the ``torch`` one
    (:func:`ref_backward`).
    """
    pol = resolve_policy(policy)
    impl = pol.impl_for(op)
    table = implementations(op)
    if impl not in table:
        raise KeyError(f"kernel op {op!r} has no implementation {impl!r}; "
                       f"registered: {sorted(table)}")
    merged = {**kwargs, **pol.params_for(op)}
    if impl == "torch":
        return _observed(op, lambda: table[impl](*arrays, **merged),
                         arrays, merged)
    return _observed(op, lambda: ref_backward(
        table[impl], table["torch"], *arrays, **merged), arrays, merged)


# ===========================================================================
# Launch-plan shapes of the cuda implementations' arguments
# ===========================================================================
def _attn_shapes(q, k, v, *, chunk: int = 512, **_):
    B, S, Hq, D = q.shape
    _, T, Hkv, _ = k.shape
    _require(tuple(k.shape) == (B, T, Hkv, D) == tuple(v.shape)
             and k.dtype == q.dtype == v.dtype,
             f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} do "
             f"not match q {tuple(q.shape)}")
    # the output is a fresh allocation; views may not be 16-byte aligned
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return (B, S, T, Hq, Hkv, D, q.dtype), {"chunk": chunk,
                                            "aligned": aligned}


def _decode_shapes(q, k_cache, v_cache, kv_mask, **_):
    B, Hq, D = q.shape
    W, Hkv = k_cache.shape[1], k_cache.shape[2]
    _require(tuple(k_cache.shape) == (B, W, Hkv, D) == tuple(v_cache.shape)
             and k_cache.dtype == q.dtype and tuple(kv_mask.shape) == (B, W),
             "decode_attention: cache or mask does not match q")
    return (B, W, Hq, Hkv, D, q.dtype), {}


def _paged_shapes(q, k_pages, v_pages, page_table, kv_mask, **_):
    B, Hq, D = q.shape
    Pn, ps, Hkv = k_pages.shape[:3]
    NP = page_table.shape[1]
    _require(tuple(k_pages.shape) == (Pn, ps, Hkv, D) == tuple(v_pages.shape)
             and k_pages.dtype == q.dtype
             and tuple(page_table.shape) == (B, NP)
             and tuple(kv_mask.shape) == (B, NP * ps),
             "paged_decode_attention: pool, table or mask does not match q")
    return (B, NP, ps, Hq, Hkv, D, q.dtype), {}


def _rmsnorm_shapes(x, scale, **_):
    # the wrapper passes an f32 contiguous scale as it is, else a copy
    kept = scale.dtype == torch.float32 and scale.is_contiguous()
    return (tuple(x.shape), x.dtype), {
        "scale_shape": tuple(scale.shape),
        "scale_aligned": not kept or scale.data_ptr() % 16 == 0}


def _ssd_shapes(x, dt, A, B, C, *, chunk: int = 128, **_):
    b, S, nh, hp = x.shape
    _require(tuple(dt.shape) == (b, S, nh) and tuple(A.shape) == (nh,)
             and B.dim() == 4 and tuple(B.shape[:3]) == (b, S, nh)
             and C.shape == B.shape and B.dtype == x.dtype == C.dtype
             and dt.dtype == torch.float32 == A.dtype,
             "ssd_scan: shapes or dtypes disagree")
    return (b, S, nh, hp, B.shape[-1], x.dtype), {"chunk": chunk}


def _moe_shapes(x, w, expert_of_row, *, n_experts: int, **_):
    T, d = x.shape
    E, _, f = w.shape
    _require(tuple(w.shape) == (E, d, f) and w.dtype == x.dtype,
             f"moe_gemm: w {tuple(w.shape)} {w.dtype} does not match x "
             f"{tuple(x.shape)} {x.dtype}")
    return (T, d, f, n_experts, x.dtype), {
        "expert_of_row": _host_array(expert_of_row)}


def _qmm_shapes(x, w_q, scale, **_):
    T, K = x.shape
    N = w_q.shape[-1]
    _require(tuple(w_q.shape) == (K, N) and w_q.dtype == torch.int8
             and tuple(scale.shape) == (N,),
             f"quant_matmul: x {tuple(x.shape)}, w_q {tuple(w_q.shape)} "
             f"{w_q.dtype}, scale {tuple(scale.shape)}")
    return (T, K, N, x.dtype), {}


def _quant_rows(op, q, k, v, ks, vs, rows):
    D = q.shape[2]
    _require(tuple(k.shape) == tuple(rows) + (D,) == tuple(v.shape)
             and k.dtype == torch.int8 == v.dtype
             and tuple(ks.shape) == tuple(rows) == tuple(vs.shape)
             and ks.dtype == torch.bfloat16 == vs.dtype,
             f"{op}: int8 payloads or bf16 scales do not match")


def _qdec_shapes(q, k_q, v_q, k_scale, v_scale, kv_mask, **_):
    B, Hq, D = q.shape
    W, Hkv = k_q.shape[1], k_q.shape[2]
    _quant_rows("quant_decode_attention", q, k_q, v_q, k_scale, v_scale,
                (B, W, Hkv))
    _require(tuple(kv_mask.shape) == (B, W),
             "quant_decode_attention: mask does not match")
    return (B, W, Hq, Hkv, D, q.dtype), {}


def _qpaged_shapes(q, k_pages, v_pages, k_scales, v_scales, page_table,
                   kv_mask, **_):
    B, Hq, D = q.shape
    Pn, ps, Hkv = k_pages.shape[:3]
    NP = page_table.shape[1]
    _quant_rows("quant_paged_decode_attention", q, k_pages, v_pages,
                k_scales, v_scales, (Pn, ps, Hkv))
    _require(tuple(page_table.shape) == (B, NP)
             and tuple(kv_mask.shape) == (B, NP * ps),
             "quant_paged_decode_attention: table or mask does not match")
    return (B, NP, ps, Hq, Hkv, D, q.dtype), {}


# Registration-time examples of the int8 cuda impls (the reference's):
# operands on meta, no kwargs.
def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _quant_matmul_example():
    return (_meta((8, 256), torch.float32), _meta((256, 128), torch.int8),
            _meta((128,), torch.float32)), {}


def _quant_decode_example():
    B, Hq, Hkv, D, W = 2, 4, 2, 64, 256
    return (_meta((B, Hq, D), torch.float32),
            _meta((B, W, Hkv, D), torch.int8),
            _meta((B, W, Hkv, D), torch.int8),
            _meta((B, W, Hkv), torch.bfloat16),
            _meta((B, W, Hkv), torch.bfloat16),
            _meta((B, W), torch.bool)), {}


def _quant_paged_decode_example():
    B, Hq, Hkv, D, Pn, ps, NP = 2, 4, 2, 64, 16, 8, 4
    return (_meta((B, Hq, D), torch.float32),
            _meta((Pn, ps, Hkv, D), torch.int8),
            _meta((Pn, ps, Hkv, D), torch.int8),
            _meta((Pn, ps, Hkv), torch.bfloat16),
            _meta((Pn, ps, Hkv), torch.bfloat16),
            _meta((B, NP), torch.int32), _meta((B, NP * ps), torch.bool)), {}


# ===========================================================================
# Implementations (kernel modules are imported at call time: they import
# RMSNORM_EPS from here)
# ===========================================================================
@register_impl("prefill_attention", "torch")
def _prefill_attention_torch(q, k, v, *, causal: bool = True,
                             window: int = 0, chunk: int = 512, **_):
    from repro_torch.kernels.flash_attention import flash_attention_plain
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 chunk=chunk)


@register_impl("prefill_attention", "cuda")
@planned("repro_torch.kernels.flash_attention", "launch_plan", _attn_shapes)
def _prefill_attention_cuda(q, k, v, *, causal: bool = True,
                            window: int = 0, chunk: int = 512, **_):
    from repro_torch.kernels.flash_attention import flash_attention
    return flash_attention(q, k, v, causal=causal, window=window,
                           chunk=chunk)


@register_impl("decode_attention", "torch")
def _decode_attention_torch(q, k_cache, v_cache, kv_mask, **_):
    from repro_torch.kernels.decode_attention import decode_attention_plain
    return decode_attention_plain(q, k_cache, v_cache, kv_mask)


@register_impl("decode_attention", "cuda")
@planned("repro_torch.kernels.decode_attention", "launch_plan",
         _decode_shapes)
def _decode_attention_cuda(q, k_cache, v_cache, kv_mask, **_):
    from repro_torch.kernels.decode_attention import decode_attention
    return decode_attention(q, k_cache, v_cache, kv_mask)


@register_impl("rmsnorm", "torch")
def _rmsnorm_torch(x, scale, *, eps: float = RMSNORM_EPS, **_):
    from repro_torch.kernels.rmsnorm import rmsnorm_plain
    return rmsnorm_plain(x, scale, eps=eps)


@register_impl("rmsnorm", "cuda")
@planned("repro_torch.kernels.rmsnorm", "launch_plan", _rmsnorm_shapes)
def _rmsnorm_cuda(x, scale, *, eps: float = RMSNORM_EPS, **_):
    from repro_torch.kernels.rmsnorm import rmsnorm
    return rmsnorm(x, scale, eps=eps)


@register_impl("paged_decode_attention", "torch")
def _paged_decode_attention_torch(q, k_pages, v_pages, page_table, kv_mask,
                                  **_):
    from repro_torch.kernels.paged_attention import \
        paged_decode_attention_plain
    return paged_decode_attention_plain(q, k_pages, v_pages, page_table,
                                        kv_mask)


@register_impl("paged_decode_attention", "cuda")
@planned("repro_torch.kernels.paged_attention", "launch_plan",
         _paged_shapes)
def _paged_decode_attention_cuda(q, k_pages, v_pages, page_table, kv_mask,
                                 **_):
    from repro_torch.kernels.paged_attention import paged_decode_attention
    return paged_decode_attention(q, k_pages, v_pages, page_table, kv_mask)


@register_impl("quant_decode_attention", "torch")
def _quant_decode_attention_torch(q, k_q, v_q, k_scale, v_scale, kv_mask,
                                  **_):
    from repro_torch.kernels.quant import quant_decode_attention_plain
    return quant_decode_attention_plain(q, k_q, v_q, k_scale, v_scale,
                                        kv_mask)


@register_impl("quant_decode_attention", "cuda",
               example=_quant_decode_example)
@planned("repro_torch.kernels.quant", "quant_decode_attention_plan",
         _qdec_shapes, "quant_decode_attention_library_plan")
def _quant_decode_attention_cuda(q, k_q, v_q, k_scale, v_scale, kv_mask,
                                 **_):
    from repro_torch.kernels.quant import quant_decode_attention
    return quant_decode_attention(q, k_q, v_q, k_scale, v_scale, kv_mask)


@register_impl("quant_paged_decode_attention", "torch")
def _quant_paged_decode_attention_torch(q, k_pages, v_pages, k_scales,
                                        v_scales, page_table, kv_mask, **_):
    from repro_torch.kernels.quant import quant_paged_decode_attention_plain
    return quant_paged_decode_attention_plain(
        q, k_pages, v_pages, k_scales, v_scales, page_table, kv_mask)


@register_impl("quant_paged_decode_attention", "cuda",
               example=_quant_paged_decode_example)
@planned("repro_torch.kernels.quant", "quant_paged_decode_attention_plan",
         _qpaged_shapes, "quant_paged_decode_attention_library_plan")
def _quant_paged_decode_attention_cuda(q, k_pages, v_pages, k_scales,
                                       v_scales, page_table, kv_mask, **_):
    from repro_torch.kernels.quant import quant_paged_decode_attention
    return quant_paged_decode_attention(q, k_pages, v_pages, k_scales,
                                        v_scales, page_table, kv_mask)


@register_impl("ssd_scan", "torch")
def _ssd_scan_torch(x, dt, A, B, C, *, chunk: int = 128, **_):
    from repro_torch.kernels.ssd_scan import ssd_chunked
    return ssd_chunked(x, dt, A, B, C, chunk)


@register_impl("ssd_scan", "cuda")
@planned("repro_torch.kernels.ssd_scan", "launch_plan", _ssd_shapes)
def _ssd_scan_cuda(x, dt, A, B, C, *, chunk: int = 128, **_):
    from repro_torch.kernels.ssd_scan import ssd_scan
    return ssd_scan(x, dt, A, B, C, chunk=chunk)


@register_impl("moe_gemm", "torch")
def _moe_gemm_torch(x, w, expert_of_row, *, n_experts: int, **_):
    from repro_torch.kernels.moe_gemm import moe_gemm_plain
    return moe_gemm_plain(x, w, expert_of_row, n_experts=n_experts)


@register_impl("moe_gemm", "cuda")
@planned("repro_torch.kernels.moe_gemm", "moe_gemm_plan", _moe_shapes,
         "moe_gemm_library_plan")
def _moe_gemm_cuda(x, w, expert_of_row, *, n_experts: int, **_):
    from repro_torch.kernels.moe_gemm import moe_gemm
    return moe_gemm(x, w, expert_of_row, n_experts=n_experts)


@register_impl("quant_matmul", "torch")
def _quant_matmul_torch(x, w_q, scale, **_):
    from repro_torch.kernels.quant import quant_matmul_plain
    return quant_matmul_plain(x, w_q, scale)


@register_impl("quant_matmul", "cuda", example=_quant_matmul_example)
@planned("repro_torch.kernels.quant", "quant_matmul_plan", _qmm_shapes,
         "quant_matmul_library_plan")
def _quant_matmul_cuda(x, w_q, scale, **_):
    from repro_torch.kernels.quant import quant_matmul
    return quant_matmul(x, w_q, scale)
