"""Paged KV serving of the port: cache capacity bounded by device bytes,
not slots (counterpart of ``repro.serve.paged``).

* :class:`PagedKVCache` — a host-side allocator over a pool of
  fixed-size pages: free-list alloc/release, per-page refcounts, and a
  prefix registry that shares prompt-prefix pages across requests. It
  behaves as the reference's does, step for step: the same free-list
  order, refcounts, LRU eviction order and blake2b chain keys. Sharing is
  copy-on-write by construction: decode writes only at positions past
  the shared prefix, which land in the writer's private pages.
* :class:`PagedServeEngine` — :class:`~repro_torch.serve.engine.
  ServeEngine` with the contiguous cache swapped for one pooled
  ``(L, n_pages, page_size, Hkv, hd)`` buffer per K and V plus per-slot
  page tables (``models.model.paged_cache_spec``). Admission allocates a
  request's worst-case pages up front and waits on the page budget;
  retirement frees them and points the slot's table row at the null
  page. Prefill runs at the scheduler's shapes, then its rows are
  scattered into the pool through the table. The table, ``pos`` and the
  pools are updated in place on the device.
* prefix caching — full prompt pages are registered under a chained
  content hash; a later prompt sharing the prefix maps those pages into
  its table, sets ``pos`` past them and decode-feeds only its tail.
* recurrent state — the ``ssm`` family's ``conv``/``ssm`` leaves are O(1)
  per slot and stay contiguous: admission splices them with ``pos``, and
  a pure-SSM model holds no pages at all.

Token streams equal the contiguous engine's on the same requests: the
prefill is shared, the paged decode attends over the same rows, and
sampling is seeded per request id.
"""
from __future__ import annotations

import hashlib
import logging
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.model import (PAGED_CACHE_AXES, decode_step_paged,
                                      init_paged_cache, kv_torch_dtype,
                                      page_count, torch_dtype,
                                      write_prefill_pages,
                                      write_prefill_pages_quant)
from repro_torch.serve.engine import Request, ServeEngine, _splice
from repro_torch.serve.scheduler import PAD_SAFE_FAMILIES, AdmissionPlan

log = logging.getLogger("repro_torch.serve")

#: Physical page 0 is never allocated: unowned page-table entries point
#: at it and retired slots write their (masked) decode rows into it.
NULL_PAGE = 0


class PagesExhausted(RuntimeError):
    """Raised by :meth:`PagedKVCache.alloc` when the pool cannot supply
    the requested pages even after evicting idle prefix pages."""


def prefix_page_keys(tokens: np.ndarray, page_size: int,
                     n_pages: Optional[int] = None) -> List[bytes]:
    """Chained content hash of each *full* page of ``tokens``: page i's
    key commits to tokens[0 : (i+1)*page_size], so a key matches only
    when the entire prefix through that page matches."""
    toks = np.asarray(tokens, np.int64)
    total = len(toks) // page_size
    n = total if n_pages is None else min(n_pages, total)
    keys, h = [], hashlib.blake2b(digest_size=16)
    for i in range(n):
        h.update(toks[i * page_size:(i + 1) * page_size].tobytes())
        keys.append(h.digest())
        h = hashlib.blake2b(keys[-1], digest_size=16)
    return keys


class PagedKVCache:
    """Host-side page allocator + prefix registry (no device state: the
    pools live in the engine's cache).

    ``capacity`` pages are allocatable (physical pages 1..n_pages-1;
    page 0 is the reserved null page). Every allocated page carries a
    refcount; :meth:`release` frees at zero. Prefix registration adds
    one registry reference, so a registered page idles at refcount 1
    until a later prompt maps it (hit) or the allocator evicts it (LRU)
    to satisfy a new allocation.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page 0 is the null "
                             f"page), got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._rc = np.zeros((n_pages,), np.int64)
        self._prefix: "OrderedDict[bytes, int]" = OrderedDict()  # key->page
        self._key_of: Dict[int, bytes] = {}                      # page->key
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # ------------------------------------------------------------- queries
    @property
    def capacity(self) -> int:
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def evictable_pages(self) -> int:
        """Registered pages held only by the registry (refcount 1)."""
        return sum(1 for p in self._prefix.values() if self._rc[p] == 1)

    @property
    def live_pages(self) -> int:
        return self.capacity - self.free_pages

    def refcount(self, page: int) -> int:
        return int(self._rc[page])

    def can_allocate(self, n: int) -> bool:
        return self.free_pages + self.evictable_pages >= n

    # ---------------------------------------------------------- alloc/free
    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages off the free list (evicting idle prefix
        pages LRU-first if needed); each comes back with refcount 1."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if not self.can_allocate(n):
            raise PagesExhausted(
                f"need {n} pages, have {self.free_pages} free + "
                f"{self.evictable_pages} evictable of {self.capacity}")
        while self.free_pages < n:
            self._evict_one()
        pages = [self._free.pop() for _ in range(n)]
        self._rc[pages] += 1
        return pages

    def retain(self, pages: Sequence[int]):
        for p in pages:
            if self._rc[p] < 1:
                raise PagesExhausted(f"retain of free page {p}")
            self._rc[p] += 1

    def release(self, pages: Sequence[int]):
        for p in pages:
            if p == NULL_PAGE:
                continue
            if self._rc[p] < 1:
                raise PagesExhausted(f"double release of page {p}")
            self._rc[p] -= 1
            if self._rc[p] == 0:
                self._free.append(int(p))

    def _evict_one(self):
        for key, page in self._prefix.items():        # insertion = LRU order
            if self._rc[page] == 1:
                del self._prefix[key]
                del self._key_of[page]
                self.release([page])
                self.evictions += 1
                return
        raise PagesExhausted("no evictable prefix pages")

    # ------------------------------------------------------------- prefixes
    def lookup(self, tokens: np.ndarray,
               max_pages: Optional[int] = None) -> List[int]:
        """Longest-prefix walk: the registered pages whose chained keys
        match ``tokens``'s leading full pages. Matched pages are
        retained for the caller and touched to MRU."""
        keys = prefix_page_keys(tokens, self.page_size, max_pages)
        pages: List[int] = []
        for key in keys:
            page = self._prefix.get(key)
            if page is None:
                break
            pages.append(page)
        self.retain(pages)
        for key in keys[: len(pages)]:
            self._prefix.move_to_end(key)
        if pages:
            self.hits += 1
        else:
            self.misses += 1
        return pages

    def register(self, tokens: np.ndarray, pages: Sequence[int]):
        """Publish ``pages`` (the caller's content-final pages holding
        ``tokens``'s leading full pages) for future sharing. Each newly
        registered page gains the registry's reference; keys already
        present keep their existing page (the caller's copy stays
        private and frees normally)."""
        keys = prefix_page_keys(tokens, self.page_size, len(pages))
        for key, page in zip(keys, pages):
            if key in self._prefix:
                continue
            self._prefix[key] = int(page)
            self._key_of[int(page)] = key
            self.retain([page])

    def drop_prefixes(self):
        """Release every registry reference (after this and the release
        of every request, all refcounts are zero: the no-leak check)."""
        pages = list(self._prefix.values())
        self._prefix.clear()
        self._key_of.clear()
        self.release(pages)


def equal_hbm_pages(cfg, rt, n_slots: int, pages_per_slot: int) -> int:
    """Pool size, null page included, that holds the contiguous engine's
    KV bytes: ``n_slots * pages_per_slot`` pages at ``kv_dtype == dtype``;
    otherwise those bytes at the activation dtype re-denominated into
    pages of the storage dtype (``D`` payload bytes plus a 2-byte bf16
    scale per row and kv head under int8), by integer floor division."""
    base = n_slots * pages_per_slot
    if rt.kv_dtype and rt.kv_dtype != rt.dtype:
        per_tok_base = cfg.head_dim * torch_dtype(rt.dtype).itemsize
        per_tok_kv = (cfg.head_dim * kv_torch_dtype(rt.kv_dtype).itemsize
                      + (2 if rt.kv_dtype == "int8" else 0))
        base = base * per_tok_base // per_tok_kv
    return base + 1


class PagedServeEngine(ServeEngine):
    """Continuous batching over a paged KV pool.

    ``page_budget`` is the pool size in pages (including the null page);
    the default matches the contiguous engine's KV bytes: ``n_slots *
    ceil(W / page_size)`` allocatable pages at ``kv_dtype == dtype``,
    re-denominated into the cache's storage bytes otherwise (an int8 row
    costs ``D + 2`` bytes per kv head with its bf16 scale, so the same
    bytes buy about ``2D / (D + 2)`` times the pages). ``n_slots`` still
    bounds the decode batch, but admission waits on pages.

    ``prefix_cache`` shares prompt-prefix pages; it is sound only for
    pad-safe families without a sliding window, and is off elsewhere.
    """

    def __init__(self, params, cfg, rt, n_slots: int = 4,
                 max_len: int = 512, page_size: int = 16,
                 page_budget: Optional[int] = None,
                 prefix_cache: bool = True, **kw):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        window = max_len
        if cfg.sliding_window:
            window = min(cfg.sliding_window, max_len)
        self._npp = page_count(window, page_size)   # page-table width
        if page_budget is None:
            page_budget = equal_hbm_pages(cfg, rt, n_slots, self._npp)
        self.n_pages = int(page_budget)
        self.pages = PagedKVCache(self.n_pages, self.page_size)
        self._prefix_on = bool(prefix_cache) \
            and cfg.family in PAD_SAFE_FAMILIES \
            and not cfg.sliding_window
        # (shared, private) physical pages held per slot
        self._slot_pages: List[Tuple[List[int], List[int]]] = \
            [([], []) for _ in range(n_slots)]
        super().__init__(params, cfg, rt, n_slots=n_slots,
                         max_len=max_len, **kw)

    # ------------------------------------------------------------ cache hooks
    def _init_cache(self):
        return init_paged_cache(self.cfg, self.n_slots, self.n_pages,
                                self.page_size, self.max_len, self.rt.dtype,
                                self.rt.kv_dtype, device=self.device)

    def _decode(self, tokens: torch.Tensor) -> torch.Tensor:
        self.cache, logits = decode_step_paged(
            self.params, self.cfg, self.cache, tokens, self.rt,
            page_size=self.page_size, window=self.scheduler.window)
        return logits

    def _cache_axes(self) -> Dict[str, tuple]:
        return PAGED_CACHE_AXES

    @property
    def _has_kv(self) -> bool:
        return "kp" in self.cache

    # ---------------------------------------------------------------- budget
    def _scatter_pages(self, plan: AdmissionPlan) -> int:
        """Pages the prefill bucket's rows span (the scatter width)."""
        return page_count(min(plan.prefill_len, self.scheduler.window),
                          self.page_size)

    def _admit_need(self, req: Request,
                    plan: Optional[AdmissionPlan] = None) -> int:
        """Worst-case pages an admission allocates up front: the pages
        the request can ever address (window-capped) or, if larger, the
        prefill bucket's scatter span (its tail pages are freed right
        after the scatter). A model without KV needs none."""
        if not self._has_kv:
            return 0
        need = self.scheduler.pages_for(len(req.prompt),
                                        req.max_new_tokens, self.page_size)
        if plan is None:
            plan = self.scheduler.plan(len(req.prompt))
        return max(need, self._scatter_pages(plan))

    def submit(self, req: Request):
        """Page-budget admission control on top of the base cache-bounds
        contract: a request whose worst-case pages exceed the pool can
        never be admitted, so it is rejected, truncated or refused now
        rather than blocking the queue head."""
        S = int(len(req.prompt))
        if S >= 1 and self._has_kv:
            ps, cap = self.page_size, self.pages.capacity
            need = self.scheduler.pages_for(S, req.max_new_tokens, ps)
            scatter = self._scatter_pages(self.scheduler.plan(S))
            if max(need, scatter) > cap:
                why = (f"needs {max(need, scatter)} pages of page_size="
                       f"{ps} > pool capacity {cap}")
                if self.overflow == "error":
                    raise ValueError(f"request rid={req.rid} over page "
                                     f"budget: {why}")
                budget = cap * ps - S
                if (self.overflow == "truncate" and scatter <= cap
                        and budget >= 1):
                    log.warning("rid=%d truncated: %s -> max_new_tokens=%d",
                                req.rid, why, budget)
                    req.max_new_tokens = budget
                    req.truncated = True
                else:
                    self._reject(req, why)
                    return
        super().submit(req)

    # ---------------------------------------------------------------- admit
    def _admit(self):
        free = [i for i, r in enumerate(self.slots) if r is None]
        while free and self.queue:
            if not self.pages.can_allocate(self._admit_need(self.queue[0])):
                break                  # head of line waits for pages
            group, plan = self._next_group(len(free))
            slots = free[: len(group)]
            free = free[len(group):]
            self._admit_group(group, plan, slots)

    def _next_group(self, n_free: int):
        """Same-plan grouping as the base engine, additionally gated on
        the *cumulative* page budget of the group."""
        width = self.scheduler.admit_width
        req0 = self.queue.pop(0)
        plan = self.scheduler.plan(len(req0.prompt))
        group = [req0]
        pages_needed = self._admit_need(req0, plan)
        while len(group) < min(width, n_free) and self.queue:
            nxt = self.queue[0]
            if self.scheduler.plan(len(nxt.prompt)) != plan:
                break
            need = self._admit_need(nxt, plan)
            if not self.pages.can_allocate(pages_needed + need):
                break
            pages_needed += need
            group.append(self.queue.pop(0))
        return group, plan

    def _admit_group(self, group: List[Request], plan: AdmissionPlan,
                     slots: List[int]):
        if not self._has_kv:
            # pure SSM: nothing pages (the page table rides along unused)
            single, logits_np = self._prefill_group(group, plan)
            self._splice_slot_leaves(single, slots)
            for j, (req, slot) in enumerate(zip(group, slots)):
                self._finish_admit(req, slot, plan, logits_np[j])
            return
        cold: List[Tuple[Request, int]] = []
        for req, slot in zip(group, slots):
            shared: List[int] = []
            if self._prefix_on:
                # leave at least one prompt token to decode-feed: the
                # step needs a last token to run on
                max_shared = (len(req.prompt) - 1) // self.page_size
                if max_shared >= 1:
                    shared = self.pages.lookup(req.prompt, max_shared)
            if shared:
                self._admit_prefix_hit(req, slot, shared)
            else:
                cold.append((req, slot))
        if cold:
            self._admit_cold(cold, plan)

    def _splice_slot_leaves(self, single, slots: List[int]):
        """Splice the per-slot leaves a prefill produced (``pos`` and any
        recurrent state) into ``slots`` as the contiguous engine does;
        only the KV rows page."""
        names = [n for n in ("pos", "conv", "ssm") if n in self.cache]
        _splice({n: self.cache[n] for n in names},
                {n: single[n] for n in names}, slots,
                rows=range(len(slots)), axes=self._cache_axes())

    def _admit_prefix_hit(self, req: Request, slot: int,
                          shared: List[int]):
        """Admission that skips prefill: the shared pages already hold
        the prefix KV; the unshared prompt tail rides the decode step as
        forced tokens (the chunked-prefill machinery)."""
        ps = self.page_size
        shared_len = len(shared) * ps
        need = self.scheduler.pages_for(len(req.prompt),
                                        req.max_new_tokens, ps)
        private = self.pages.alloc(need - len(shared))
        self._slot_pages[slot] = (shared, private)
        self._set_page_table([slot], [shared + private])
        self.cache["pos"][slot] = shared_len
        self.stats.prefix_hits += 1
        self.stats.prefix_hit_tokens += shared_len
        plan = AdmissionPlan("chunk", shared_len)
        self._finish_admit(req, slot, plan, None, start_pos=shared_len)

    def _admit_cold(self, pairs: List[Tuple[Request, int]],
                    plan: AdmissionPlan):
        ps = self.page_size
        group = [req for req, _ in pairs]
        slots = [slot for _, slot in pairs]
        single, logits_np = self._prefill_group(group, plan)

        n_scatter = self._scatter_pages(plan)
        width = max(self.scheduler.admit_width, len(pairs))
        page_ids = np.zeros((width, n_scatter), np.int32)   # pads -> null
        held: List[List[int]] = []
        for j, (req, _) in enumerate(pairs):
            pages = self.pages.alloc(self._admit_need(req, plan))
            page_ids[j] = pages[:n_scatter]
            held.append(pages)
        ids = torch.from_numpy(page_ids).to(self.device)
        with torch.no_grad():
            if "ks" in self.cache:
                # int8 KV: the prefill rows are already quantized
                write_prefill_pages_quant(
                    self.cache["kp"], self.cache["vp"], self.cache["ks"],
                    self.cache["vs"], single["k"], single["v"],
                    single["ks"], single["vs"], ids, page_size=ps)
            else:
                write_prefill_pages(self.cache["kp"], self.cache["vp"],
                                    single["k"], single["v"], ids,
                                    page_size=ps)
        self._splice_slot_leaves(single, slots)

        rows = []
        for j, (req, slot) in enumerate(pairs):
            pages, need = held[j], self.scheduler.pages_for(
                len(req.prompt), req.max_new_tokens, ps)
            if len(pages) > need:       # scatter-only tail: pad rows the
                self.pages.release(pages[need:])   # mask hides forever
                pages = pages[:need]
            self._slot_pages[slot] = ([], pages)
            rows.append(pages)
            if self._prefix_on and plan.mode == "pad":
                # pad mode prefilled the whole prompt: its full pages
                # are content-final, so publish them for sharing
                n_full = min(len(req.prompt) // ps, len(pages))
                self.pages.register(req.prompt, pages[:n_full])
        self._set_page_table(slots, rows)
        for j, (req, slot) in enumerate(pairs):
            self._finish_admit(req, slot, plan, logits_np[j])

    def _set_page_table(self, slots: List[int], rows):
        """Write ``rows`` (ragged lists of physical pages) into the
        device page table in place, null-padded to the table width."""
        table = np.zeros((len(slots), self._npp), np.int32)
        for i, row in enumerate(rows):
            table[i, : len(row)] = row
        idx = torch.as_tensor(slots, dtype=torch.long, device=self.device)
        self.cache["pt"][idx] = torch.from_numpy(table).to(self.device)

    # ---------------------------------------------------------------- retire
    def _release_slot(self, slot: int):
        shared, private = self._slot_pages[slot]
        self.pages.release(shared)
        self.pages.release(private)
        self._slot_pages[slot] = ([], [])
        # repoint the stale table row at the null page so the retired
        # slot's (masked) decode writes can never touch rebound pages
        self._set_page_table([slot], [[]])

    # ---------------------------------------------------------------- stats
    def _allocated_tokens(self, active: List[int]) -> int:
        if not self._has_kv:
            return super()._allocated_tokens(active)
        held = sum(len(sh) + len(pv)
                   for sh, pv in (self._slot_pages[s] for s in active))
        return held * self.page_size

    @property
    def prefix_hit_rate(self) -> float:
        total = self.pages.hits + self.pages.misses
        return self.pages.hits / total if total else 0.0
