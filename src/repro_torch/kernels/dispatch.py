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
"""
from __future__ import annotations

import contextlib
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


def register_impl(op: str, impl: str) -> Callable[[Callable], Callable]:
    """Decorator: register ``fn`` as implementation ``impl`` of ``op``."""
    if op not in _TABLE:
        raise KeyError(f"unknown kernel op {op!r}; registered: {KERNEL_OPS}")

    def deco(fn: Callable) -> Callable:
        _TABLE[op][impl] = fn
        return fn

    return deco


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


@contextlib.contextmanager
def observe_kernels(observer: Callable) -> Iterator[None]:
    """Install ``observer`` for the block. Each kernel call then returns
    ``observer(op, run, arrays, kwargs)`` in place of ``run()``, where
    ``run`` makes the call as it stands (the policy's implementation on
    the caller's arguments); the observer decides whether to call it."""
    global _OBSERVER
    prev, _OBSERVER = _OBSERVER, observer
    try:
        yield
    finally:
        _OBSERVER = prev


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
def _decode_attention_cuda(q, k_cache, v_cache, kv_mask, **_):
    from repro_torch.kernels.decode_attention import decode_attention
    return decode_attention(q, k_cache, v_cache, kv_mask)


@register_impl("rmsnorm", "torch")
def _rmsnorm_torch(x, scale, *, eps: float = RMSNORM_EPS, **_):
    from repro_torch.kernels.rmsnorm import rmsnorm_plain
    return rmsnorm_plain(x, scale, eps=eps)


@register_impl("rmsnorm", "cuda")
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


@register_impl("quant_decode_attention", "cuda")
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


@register_impl("quant_paged_decode_attention", "cuda")
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
def _ssd_scan_cuda(x, dt, A, B, C, *, chunk: int = 128, **_):
    from repro_torch.kernels.ssd_scan import ssd_scan
    return ssd_scan(x, dt, A, B, C, chunk=chunk)


@register_impl("moe_gemm", "torch")
def _moe_gemm_torch(x, w, expert_of_row, *, n_experts: int, **_):
    from repro_torch.kernels.moe_gemm import moe_gemm_plain
    return moe_gemm_plain(x, w, expert_of_row, n_experts=n_experts)


@register_impl("moe_gemm", "cuda")
def _moe_gemm_cuda(x, w, expert_of_row, *, n_experts: int, **_):
    from repro_torch.kernels.moe_gemm import moe_gemm
    return moe_gemm(x, w, expert_of_row, n_experts=n_experts)


@register_impl("quant_matmul", "torch")
def _quant_matmul_torch(x, w_q, scale, **_):
    from repro_torch.kernels.quant import quant_matmul_plain
    return quant_matmul_plain(x, w_q, scale)


@register_impl("quant_matmul", "cuda")
def _quant_matmul_cuda(x, w_q, scale, **_):
    from repro_torch.kernels.quant import quant_matmul
    return quant_matmul(x, w_q, scale)
