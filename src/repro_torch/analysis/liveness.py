"""Static buffer liveness over the serving hot paths + the capacity
model's drift guards (the counterpart of ``repro.analysis.liveness``).

:func:`live_peak` runs a function on ``meta`` tensors under a
``TorchDispatchMode`` and tracks the bytes of every live storage, a
view counted once with its storage. What the call allocates lives until
its last tensor is freed (a ``weakref`` finalizer on the storage), as
PyTorch's allocator sees it; the call's arguments count from the start
until their last use, as a jaxpr's inputs do in the reference's walk.
Nothing is allocated. It is a guide for ranking hotspots and for
proving that the step threads its whole cache, deliberately **not** the
number ``launch/serve.py --preflight`` uses: that is the calibrated
closed-form model of :mod:`repro_torch.analysis.capacity`. The kernel
calls run their plain versions (``KernelPolicy.torch()``), as the
abstract trace of ``core/workload/torch_trace.py`` runs them.

The pass checks *contracts*, not bytes against HBM:

* the capacity model still evaluates on every preset arch (a params or
  cache tree drift raises inside it -> ``capacity-spec-drift``);
* its baked constant ``ATTN_CHUNK`` still matches the runtime default
  it was calibrated at (``ModelRuntime().attn_chunk``; the port has no
  dry run to lower cells at);
* the decode walk keeps params and cache live across the step, and the
  step updates the cache in place: every cache leaf comes back as the
  storage it went in as, at its shape, dtype and stride, and no buffer
  of a leaf's shape and dtype is allocated (the port's counterpart of
  the reference's donation; :func:`cache_in_place`, which the graph
  lint's ``graph-trace-unstable`` calls too);
* every ``Scheduler.prefill_lengths`` bucket walks;
* the serving config at the preset's width still fits the card
  (``capacity-hbm-overflow``, the rule ``--preflight`` names).
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.findings import Finding, Location
from repro_torch.analysis.registry import AnalysisContext, register_pass


# ===========================================================================
# The walk
# ===========================================================================
def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Walk(TorchDispatchMode):
    """Records, per op, the storages it allocates and the argument
    storages it reads; finalizers record each allocation's death."""

    def __init__(self, arg_keys: Dict[int, int]) -> None:
        super().__init__()
        self.args = arg_keys                # storage key -> bytes
        self.last_use: Dict[int, int] = {}
        self.known = set(arg_keys)
        self.allocs: List[Tuple[int, int]] = []      # (op, bytes)
        self.deaths: List[Tuple[int, int]] = []      # (before op, bytes)
        self.shapes: List[Tuple[Tuple[int, ...], torch.dtype]] = []
        self.op = 0

    def _free(self, key: int, nbytes: int) -> None:
        self.known.discard(key)
        self.deaths.append((self.op, nbytes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = self.run(func, args, kwargs or {})
        self.account(args, kwargs, out)
        return out

    def run(self, func, args, kwargs):
        """The op itself (a subclass may stand in for it)."""
        return func(*args, **kwargs)

    def account(self, args, kwargs, out) -> None:
        """The storages ``out`` allocates and the arguments it read."""
        i = self.op
        for t in tree_flatten((args, kwargs))[0]:
            if isinstance(t, torch.Tensor) and _key(t) in self.args:
                self.last_use[_key(t)] = i
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            k = _key(t)
            if k in self.args:
                self.last_use[k] = i
            elif k not in self.known:
                self.known.add(k)
                nbytes = t.untyped_storage().nbytes()
                self.allocs.append((i, nbytes))
                self.shapes.append((tuple(t.shape), t.dtype))
                weakref.finalize(t.untyped_storage(), self._free, k, nbytes)
        self.op += 1

    def peak(self, held: bool = False) -> int:
        """Largest live bytes over the ops: each op's outputs beside its
        inputs, the arguments until their last use (with ``held``, every
        argument through the whole call, as a caller that keeps them
        holds them on the card), an allocation until the op before
        which it was freed."""
        delta = [0] * (self.op + 2)
        for k, nbytes in self.args.items():
            if held:
                delta[0] += nbytes
            elif k in self.last_use:
                delta[0] += nbytes
                delta[self.last_use[k] + 1] -= nbytes
        for i, nbytes in self.allocs:
            delta[i] += nbytes
        for i, nbytes in self.deaths:
            delta[max(i, 0)] -= nbytes
        live = best = 0
        for d in delta[:self.op + 1]:
            live += d
            best = max(best, live)
        return best


def walk(fn: Callable, *args: Any) -> Tuple[_Walk, Any]:
    """Run ``fn(*args)`` under the walk; returns the walk and fn's
    result."""
    arg_keys = {}
    for t in tree_flatten(args)[0]:
        if isinstance(t, torch.Tensor):
            arg_keys[_key(t)] = t.untyped_storage().nbytes()
    w = _Walk(arg_keys)
    with torch.no_grad(), w:
        out = fn(*args)
    return w, out


def live_peak(fn: Callable, *args: Any) -> int:
    """Peak live bytes of ``fn(*args)`` on ``meta`` tensors (module
    docstring)."""
    return walk(fn, *args)[0].peak()


# ===========================================================================
# Per-arch contract checks
# ===========================================================================
def _runtime_attn_chunk_default() -> int:
    """The ``attn_chunk`` the runtime prefills at by default — the value
    the capacity calibration's scores feature is conditioned on."""
    from repro_torch.models.model import ModelRuntime
    return ModelRuntime().attn_chunk


def _tree_bytes(tree) -> int:
    return sum(t.untyped_storage().nbytes() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def leaf_signatures(cache) -> Dict[str, Tuple]:
    """Each cache leaf's storage, shape, dtype and stride."""
    return {k: (_key(t), tuple(t.shape), t.dtype, t.stride())
            for k, t in cache.items()}


def cache_in_place(before: Dict[str, Tuple], out_cache, w: _Walk,
                   batch: int) -> Tuple[List[str], List[str]]:
    """Whether a step that was given a cache with leaf signatures
    ``before`` (:func:`leaf_signatures`) and walked as ``w`` updated it
    in place: the leaves that came back as another storage, shape, dtype
    or stride, and the shapes of the buffers of a leaf's shape and dtype
    the step allocated (a leaf of at most ``batch`` elements, the
    positions, is not held to the second)."""
    after = leaf_signatures({k: t for k, t in out_cache.items()
                             if isinstance(t, torch.Tensor)})
    moved = sorted(k for k in before if after.get(k) != before[k])
    leaf_shapes = {(s, d) for _, s, d, _ in before.values()
                   if int(np.prod(s)) > batch}
    copies = sorted({str(s) for s, d in w.shapes if (s, d) in leaf_shapes})
    return moved, copies


def _drift(symbol: str, message: str, suggestion: str = "") -> Finding:
    return Finding("capacity-spec-drift", "error", Location(symbol=symbol),
                   message, suggestion)


def lint_arch(arch: str, *, max_len: int, page_size: int, smoke: bool = True,
              batch: int = 2) -> List[Finding]:
    from repro_torch.analysis.capacity import capacity
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.core.workload.torch_trace import _abstract_params
    from repro_torch.kernels.dispatch import TORCH_POLICY
    from repro_torch.models import model as M
    from repro_torch.serve.scheduler import Scheduler

    cfg = get_arch(arch)
    cfg = smoke_config(cfg) if smoke else cfg
    findings: List[Finding] = []

    # -- the capacity model must evaluate (tree drift raises inside) --------
    try:
        report = capacity(cfg, n_slots=batch, max_len=max_len,
                          dtype="bfloat16")
    except Exception as e:
        return [_drift(
            f"capacity/{arch}",
            f"the closed-form capacity model no longer evaluates on this "
            f"arch: {type(e).__name__}: {e} — its param/cache mirror "
            f"drifted from the live trees",
            "realign analysis.capacity with models.model's "
            "param_defs/cache_spec")]
    if not report.fits:
        findings.append(Finding(
            "capacity-hbm-overflow", "error",
            Location(symbol=f"capacity/{arch}"),
            f"the serving config ({batch} slots x {max_len} tokens) "
            f"predicts {report.peak_bytes / 2**30:.2f} GiB peak, over the "
            f"{report.hbm_bytes / 2**30:.0f} GiB card",
            "shrink n_slots/max_len"))

    if cfg.is_encoder_only:
        return findings

    # -- decode walk: params and cache live, the cache updated in place -----
    rt = M.ModelRuntime(dtype="bfloat16", remat="none", kernels=TORCH_POLICY,
                        device="meta", moe_dropless=True)
    params = _abstract_params(cfg, rt)
    cache = {k: torch.zeros(s, dtype=d, device="meta")
             for k, (s, d) in M.cache_spec(cfg, batch, max_len,
                                           rt.dtype).items()}
    before = leaf_signatures(cache)
    tokens = torch.zeros((batch,), dtype=torch.int32, device="meta")
    sym = f"liveness/decode/{arch}"
    try:
        w, (out_cache, _) = walk(
            lambda p, c, t: M.decode_step(p, cfg, c, t, rt), params, cache,
            tokens)
    except Exception as e:
        return findings + [_drift(sym, f"liveness walk failed over "
                                       f"decode_step: {type(e).__name__}: "
                                       f"{e}")]
    floor = _tree_bytes(cache) + _tree_bytes(params)
    peak = w.peak()
    if peak < floor:
        findings.append(_drift(
            sym, f"decode-step peak live bytes ({peak}) fall below the "
                 f"params+cache floor ({floor}) — the step no longer reads "
                 f"every parameter and cache leaf",
            "thread every cache leaf through decode_step"))
    moved, copies = cache_in_place(before, out_cache, w, batch)
    if moved or copies:
        findings.append(_drift(
            sym, f"decode_step writes its cache out of place: leaves "
                 f"{moved} come back as other storages, buffers of cache "
                 f"leaf shapes {copies} are allocated — the step must "
                 f"update the cache it is given",
            "write the new rows into the cache leaves in place"))

    # -- prefill buckets: every scheduler bucket must walk ------------------
    sched = Scheduler(cfg, max_len)
    for L in sched.prefill_lengths:
        batch_in = {"tokens": torch.zeros((batch, L), dtype=torch.int32,
                                          device="meta")}
        lengths = (torch.full((batch,), L, dtype=torch.int32, device="meta")
                   if sched.pad_safe else None)
        try:
            live_peak(lambda p, b, lens: M.prefill(p, cfg, b, max_len, rt,
                                                   lengths=lens),
                      params, batch_in, lengths)
        except Exception as e:
            findings.append(_drift(
                f"liveness/prefill/{arch}@L{L}",
                f"liveness walk failed over the L={L} prefill bucket: "
                f"{type(e).__name__}: {e}"))
    return findings


@register_pass(
    "liveness",
    rules=("capacity-hbm-overflow", "capacity-spec-drift"),
    description="storage-liveness walk over decode/prefill on meta + "
                "capacity-model drift and HBM-overflow guards")
def run_pass(ctx: AnalysisContext) -> List[Finding]:
    from repro_torch.analysis import capacity as C

    findings: List[Finding] = []
    live_chunk = _runtime_attn_chunk_default()
    if live_chunk != C.ATTN_CHUNK:
        findings.append(_drift(
            "capacity/ATTN_CHUNK",
            f"capacity.ATTN_CHUNK={C.ATTN_CHUNK} but the runtime now "
            f"prefills at attn_chunk={live_chunk} — the calibrated scores "
            f"feature is conditioned on the old chunk size",
            "recalibrate capacity.CALIBRATION at the new chunk"))
    for arch in ctx.preset.archs:
        findings.extend(lint_arch(arch, max_len=ctx.preset.max_len,
                                  page_size=ctx.preset.page_size,
                                  smoke=ctx.preset.smoke))
    return findings
