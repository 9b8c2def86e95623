"""Serving engine of the port: scheduled prefill + batched decode with
continuous batching (counterpart of ``repro.serve.engine``).

The engine holds one jointly batched cache of ``n_slots`` sequences,
each with its own position counter. Finished slots are refilled from
the request queue by prefilling the new prompt at a
:class:`~repro_torch.serve.scheduler.Scheduler`-chosen bucketed shape and
splicing its cache into the slot by the *declared* batch axis of every
leaf (``models.model.CACHE_AXES``), in place.

Requests over the cache budget are rejected, truncated or refused at
:meth:`ServeEngine.submit` (``overflow``), never clamped silently, and
:meth:`ServeEngine.run` raises when requests remain unserved. The cache
hooks (``_init_cache``, ``_decode``, ``_cache_axes``, ``_release_slot``,
``_allocated_tokens``) are where :class:`~repro_torch.serve.paged.
PagedServeEngine` swaps in its page pool; the placement hooks
(``_place_cache``, ``_ctx``, ``_local_slots``, ``_host_logits``) are
where :class:`~repro_torch.serve.sharded.ShardedServeEngine` puts the
cache on a mesh.
"""
from __future__ import annotations

import logging
from collections import Counter
from contextlib import nullcontext
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (CACHE_AXES, ModelRuntime,
                                      cache_token_budget, cast_params,
                                      check_device, decode_step, init_cache,
                                      prefill)
from repro_torch.serve.sampling import Sampler
from repro_torch.serve.scheduler import AdmissionPlan, Scheduler

log = logging.getLogger("repro_torch.serve")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 16
    stop_tokens: Tuple[int, ...] = ()   # per-request terminators (w/ eos_id)
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    finish_reason: Optional[str] = None  # length | stop | rejected: <why>
    truncated: bool = False              # overflow='truncate' shrank budget


@dataclass
class EngineStats:
    """Live counters the launcher and the tests read."""

    # distinct (len, width) prefill shapes: eager PyTorch has no traces,
    # so each shape counts once, keeping prefill_compiles comparable with
    # Scheduler.max_prefill_compiles()
    prefill_traces: Counter = field(default_factory=Counter)
    prefills: int = 0          # prefill *calls* (>= admissions / width)
    prefill_tokens: int = 0    # tokens pushed through prefill (width * P)
    steps: int = 0             # decode steps executed
    occupancy_sum: int = 0     # sum of active slots over decode steps
    max_active: int = 0        # peak concurrent in-flight requests
    tokens_out: int = 0        # sampled (served) tokens
    forced_tokens: int = 0     # chunked-prefill prompt tokens decode-fed
    rejected: int = 0
    live_token_steps: int = 0  # live context tokens of active slots
    alloc_token_steps: int = 0  # cache tokens those requests hold
    # prefix caching (paged engine only)
    prefix_hits: int = 0        # admissions that reused >= 1 prefix page
    prefix_hit_tokens: int = 0  # prompt tokens served from shared pages

    @property
    def prefill_compiles(self) -> int:
        return sum(self.prefill_traces.values())

    def occupancy(self, n_slots: int) -> float:
        if not self.steps:
            return 0.0
        return self.occupancy_sum / (self.steps * n_slots)

    @property
    def kv_utilization(self) -> float:
        if not self.alloc_token_steps:
            return 0.0
        return self.live_token_steps / self.alloc_token_steps


def _splice(cache: Dict[str, torch.Tensor], single: Dict[str, torch.Tensor],
            slots, rows: Optional[Sequence[int]] = None,
            axes: Optional[Dict[str, tuple]] = None) -> Dict[str, torch.Tensor]:
    """Write prefilled cache rows into batch ``slots`` of ``cache``, in
    place, along each leaf's declared ``batch`` axis. ``rows`` selects
    which rows of ``single`` to take (default: the first ``len(slots)``).
    """
    axes = CACHE_AXES if axes is None else axes
    if isinstance(slots, (int, np.integer)):
        slots = [int(slots)]
    slots = list(slots)
    rows = list(rows) if rows is not None else list(range(len(slots)))
    if len(rows) != len(slots):
        raise ValueError(f"rows/slots length mismatch: {rows} vs {slots}")
    if not slots:
        return cache
    for name, big in cache.items():
        leaf_axes = axes.get(name)
        if leaf_axes is None or "batch" not in leaf_axes:
            raise KeyError(
                f"cache leaf {name!r} has no declared batch axis "
                f"(CACHE_AXES) — refusing to splice by shape guessing")
        b = leaf_axes.index("batch")
        sl = torch.as_tensor(slots, dtype=torch.long, device=big.device)
        small = single[name]
        rw = torch.as_tensor(rows, dtype=torch.long, device=small.device)
        big.index_copy_(b, sl, small.index_select(b, rw).to(big))
    return cache


class ServeEngine:
    """Continuous-batching engine: scheduled admission, budget-checked
    caches, seeded sampling, measurable stats.

    ``overflow`` governs requests whose ``prompt_len + max_new_tokens``
    exceeds ``max_len``: ``'reject'`` (default; the request lands in
    :attr:`rejected`), ``'truncate'`` (``max_new_tokens`` shrinks to fit,
    ``truncated=True``) or ``'error'`` (:meth:`submit` raises).

    ``params`` may be f32 master weights: they are cast to ``rt.dtype``
    on ``rt.device`` once, here. ``rt.device`` defaults to ``cuda``; a
    host without a card raises unless the caller passes ``cpu``.
    """

    def __init__(self, params, cfg: ModelConfig, rt: ModelRuntime,
                 n_slots: int = 4, max_len: int = 512,
                 sampler: Optional[Sampler] = None,
                 scheduler: Optional[Scheduler] = None,
                 overflow: str = "reject",
                 eos_id: Optional[int] = None):
        if cfg.is_encoder_only:
            raise ValueError(
                f"{cfg.name} is encoder-only: no autoregressive decode")
        if overflow not in ("reject", "truncate", "error"):
            raise ValueError(f"unknown overflow policy {overflow!r}")
        self.device = check_device(rt.device)
        self.params = cast_params(params, rt)
        self.cfg = cfg
        self.rt = rt
        self.n_slots = n_slots
        self.max_len = max_len
        self.sampler = sampler if sampler is not None else Sampler()
        self.scheduler = scheduler if scheduler is not None else (
            Scheduler(cfg=cfg, max_len=max_len))
        if self.scheduler.max_len != max_len:
            raise ValueError(
                f"scheduler.max_len={self.scheduler.max_len} != engine "
                f"max_len={max_len}")
        self.overflow = overflow
        self.eos_id = eos_id
        with self._ctx():
            self.cache = self._place_cache(self._init_cache())
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.last_tokens = np.zeros((n_slots,), np.int32)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.rejected: List[Request] = []
        self.stats = EngineStats()
        self._tails: List[List[int]] = [[] for _ in range(n_slots)]
        self._rngs: List[Optional[np.random.Generator]] = [None] * n_slots
        # host-side per-slot context length, for the KV-utilization
        # stats: no device sync on the hot path
        self._host_pos = np.zeros((n_slots,), np.int64)

    # -------------------------------------------------------- placement hooks
    def _place_cache(self, cache):
        """The sharded engines check the cache against their mesh; one
        device keeps it as built."""
        return cache

    def _ctx(self):
        """Ambient context every device call runs under (the mesh and
        the recipe for the sharded engines; nothing here)."""
        return nullcontext()

    def _local_slots(self, slots) -> Tuple[List[int], List[int]]:
        """(the cache rows of ``slots`` this device holds, their positions
        in ``slots``): every slot, here."""
        slots = list(slots)
        return slots, list(range(len(slots)))

    def _host_logits(self, logits: torch.Tensor,
                     prefill: bool = False) -> np.ndarray:
        """Logits as the host samples them (f32 numpy); ``prefill`` marks
        a prefill's rows."""
        return logits.float().cpu().numpy()

    # ------------------------------------------------------------ cache hooks
    def _init_cache(self) -> Dict[str, torch.Tensor]:
        """The device decode cache; the paged engine builds its pools."""
        return init_cache(self.cfg, self.n_slots, self.max_len,
                          self.rt.dtype, self.rt.kv_dtype,
                          device=self.device)

    def _decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """One decode step over every slot, in place; returns logits."""
        self.cache, logits = decode_step(self.params, self.cfg, self.cache,
                                         tokens, self.rt)
        return logits

    def _cache_axes(self) -> Dict[str, tuple]:
        """Declared logical axes of every cache leaf (for splicing)."""
        return CACHE_AXES

    def _release_slot(self, slot: int):
        """Called when the request in ``slot`` retires (the paged engine
        frees its pages here)."""

    def kv_cache_bytes(self) -> int:
        """Device bytes held by the KV cache (contiguous or paged),
        including the int8 scale side-bands."""
        return sum(self.cache[k].numel() * self.cache[k].element_size()
                   for k in ("k", "v", "kp", "vp", "ks", "vs")
                   if k in self.cache)

    def _live_tokens(self, active: List[int]) -> int:
        W = self.scheduler.window
        return int(sum(min(int(self._host_pos[s]), W) for s in active))

    def _allocated_tokens(self, active: List[int]) -> int:
        """Cache tokens the active requests hold: one full window per
        slot, live or not, in the contiguous engine."""
        return self.n_slots * self.scheduler.window

    # ---------------------------------------------------------------- admin
    def submit(self, req: Request):
        """Admission control: enforce the cache budget *now*, not after
        the cache has been corrupted."""
        S = int(len(req.prompt))
        budget = cache_token_budget(self.cfg, self.max_len, S)
        if S < 1:
            self._reject(req, "empty prompt")
            return
        if req.max_new_tokens <= budget:
            self.queue.append(req)
            return
        why = (f"prompt_len={S} + max_new_tokens={req.max_new_tokens} "
               f"> max_len={self.max_len}")
        if self.overflow == "error":
            raise ValueError(f"request rid={req.rid} over cache budget: "
                             f"{why}")
        if self.overflow == "truncate" and budget >= 1:
            log.warning("rid=%d truncated: %s -> max_new_tokens=%d",
                        req.rid, why, budget)
            req.max_new_tokens = budget
            req.truncated = True
            self.queue.append(req)
            return
        self._reject(req, why)

    def _reject(self, req: Request, why: str):
        log.warning("rid=%d rejected: %s", req.rid, why)
        req.finish_reason = f"rejected: {why}"
        self.rejected.append(req)
        self.stats.rejected += 1

    # ---------------------------------------------------------------- admit
    def _admit(self):
        free = [i for i, r in enumerate(self.slots) if r is None]
        while free and self.queue:
            group, plan = self._next_group(len(free))
            slots = free[: len(group)]
            free = free[len(group):]
            self._admit_group(group, plan, slots)

    def _next_group(self, n_free: int) -> Tuple[List[Request], AdmissionPlan]:
        """Pop up to ``admit_width`` head-of-queue requests sharing one
        admission plan (one prefill shape)."""
        width = self.scheduler.admit_width
        req0 = self.queue.pop(0)
        plan = self.scheduler.plan(len(req0.prompt))
        group = [req0]
        while (len(group) < min(width, n_free) and self.queue
               and self.scheduler.plan(len(self.queue[0].prompt)) == plan):
            group.append(self.queue.pop(0))
        return group, plan

    def _prefill_group(self, group: List[Request], plan: AdmissionPlan):
        """The (bucketed) batched prefill of one admission group; returns
        its cache and per-row logits."""
        width = max(self.scheduler.admit_width, len(group))
        P = plan.prefill_len
        toks = np.zeros((width, P), np.int32)
        lengths = np.ones((width,), np.int32)
        for j, req in enumerate(group):
            if plan.mode == "pad":
                toks[j, : len(req.prompt)] = req.prompt
                lengths[j] = len(req.prompt)
            else:                            # chunk: exact prefix
                toks[j] = req.prompt[:P]
                lengths[j] = P
        key = (P, width)
        if key not in self.stats.prefill_traces:
            self.stats.prefill_traces[key] += 1
        with torch.no_grad(), self._ctx():
            single, logits = prefill(
                self.params, self.cfg,
                {"tokens": torch.from_numpy(toks).to(self.device)},
                self.max_len, self.rt,
                lengths=torch.from_numpy(lengths).to(self.device))
            logits_np = self._host_logits(logits, prefill=True)
        self.stats.prefills += 1
        self.stats.prefill_tokens += width * P
        return single, logits_np

    def _admit_group(self, group: List[Request], plan: AdmissionPlan,
                     slots: List[int]):
        single, logits_np = self._prefill_group(group, plan)
        local, rows = self._local_slots(slots)
        _splice(self.cache, single, local, rows=rows,
                axes=self._cache_axes())
        for j, (req, slot) in enumerate(zip(group, slots)):
            self._finish_admit(req, slot, plan, logits_np[j])

    def _finish_admit(self, req: Request, slot: int, plan: AdmissionPlan,
                      logits_row: Optional[np.ndarray],
                      start_pos: Optional[int] = None):
        """Per-slot bookkeeping shared by every admission path: seed the
        sampler stream, arm the chunked-prefill tail (or emit the first
        token), record the host-side context length."""
        P = plan.prefill_len
        self.slots[slot] = req
        self._rngs[slot] = self.sampler.stream(req.rid)
        if start_pos is None:
            start_pos = len(req.prompt) if plan.mode == "pad" else P
        self._host_pos[slot] = start_pos
        if start_pos < len(req.prompt):
            # chunked prefill: the rest of the prompt rides the decode
            # step as forced inputs; prefill logits unused
            self.last_tokens[slot] = int(req.prompt[start_pos])
            self._tails[slot] = [int(t) for t in req.prompt[start_pos + 1:]]
        else:
            self._tails[slot] = []
            self._emit(slot, logits_row)

    # ---------------------------------------------------------------- step
    def _emit(self, slot: int, logits_row: np.ndarray):
        """Sample one token for ``slot``; retire the request on budget
        exhaustion or a stop token."""
        req = self.slots[slot]
        tok = self.sampler.sample(logits_row, self._rngs[slot])
        req.out_tokens.append(tok)
        self.last_tokens[slot] = tok
        self.stats.tokens_out += 1
        stop = set(req.stop_tokens)
        if self.eos_id is not None:
            stop.add(self.eos_id)
        if tok in stop:
            req.done, req.finish_reason = True, "stop"
        elif len(req.out_tokens) >= req.max_new_tokens:
            req.done, req.finish_reason = True, "length"
        if req.done:
            self.finished.append(req)
            self.slots[slot] = None
            self._tails[slot] = []
            self._rngs[slot] = None
            self._release_slot(slot)

    def step(self) -> int:
        """One engine iteration: admit new requests, decode one token for
        every slot (idle slots decode too, their rows masked and unread).
        Returns the number of active slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        self.stats.live_token_steps += self._live_tokens(active)
        self.stats.alloc_token_steps += self._allocated_tokens(active)
        self.stats.max_active = max(self.stats.max_active, len(active))
        with torch.no_grad(), self._ctx():
            logits = self._decode(
                torch.from_numpy(self.last_tokens).to(self.device))
            logits_np = self._host_logits(logits)
        for slot in active:
            self._host_pos[slot] += 1
            if self._tails[slot]:
                self.last_tokens[slot] = self._tails[slot].pop(0)
                self.stats.forced_tokens += 1
            else:
                self._emit(slot, logits_np[slot])
        self.stats.steps += 1
        self.stats.occupancy_sum += len(active)
        return len(active)

    def run(self, max_iters: int = 1000) -> List[Request]:
        """Drive until every submitted request finished. Raises if
        ``max_iters`` elapses with requests still queued or in flight."""
        it = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and it < max_iters:
            self.step()
            it += 1
        leftover = [r.rid for r in self.queue] + \
            [r.rid for r in self.slots if r is not None]
        if leftover:
            raise RuntimeError(
                f"run(max_iters={max_iters}) exhausted with requests "
                f"never served: rids={leftover} — raise max_iters or "
                f"check admission")
        return self.finished
