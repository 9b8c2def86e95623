"""Admission scheduling: prompt-length buckets + chunked prefill.

The seed engine jit-compiled prefill at every distinct prompt length —
an open vocabulary of shapes, so a production trace recompiles forever.
The :class:`Scheduler` maps every prompt onto a *fixed* set of prefill
lengths, so the engine compiles at most ``len(prefill_lengths)`` prefill
programs (times the number of admission widths in use), ever:

* **pad mode** — attention-family caches: the prompt is right-padded to
  the smallest bucket ``>= len(prompt)`` and prefilled with its real
  length threaded through (``models.model.prefill(lengths=...)``); the
  pad tokens' keys land at cache rows the decode mask hides until they
  are overwritten, so served tokens are bit-identical to exact prefill.
* **chunk mode** — SSM/hybrid recurrent state (which would absorb pad
  tokens) and prompts past the pad cap: prefill the largest bucket
  ``<= len(prompt)`` *exactly*, then stream the remaining prompt tokens
  through the already-compiled batched decode step as forced inputs.
  This is chunked prefill fused into continuous batching: the tail
  decodes ride in the same step as every other slot's token.

Pad mode is additionally capped at the KV window ``W`` for
sliding-window models: a padded length beyond ``W`` would rotate pad
keys over live rows in the circular cache.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig

#: Families whose decode cache is pure (masked) attention KV — safe to
#: right-pad at prefill. Recurrent families must use chunk mode.
PAD_SAFE_FAMILIES = ("dense", "moe", "vlm", "audio")


def default_buckets(max_len: int, lo: int = 8) -> Tuple[int, ...]:
    """Powers of two from ``lo`` up to ``max_len`` (always non-empty)."""
    out = []
    b = lo
    while b <= max_len:
        out.append(b)
        b *= 2
    return tuple(out) or (max_len,)


@dataclass(frozen=True)
class AdmissionPlan:
    """How one prompt enters the cache: ``mode`` is ``'pad'`` (prefill
    ``prefill_len >= prompt_len`` padded tokens, real length masked in)
    or ``'chunk'`` (prefill exactly ``prefill_len <= prompt_len`` tokens,
    decode-feed the rest)."""

    mode: str
    prefill_len: int


@dataclass(frozen=True)
class Scheduler:
    """Buckets prompts onto fixed prefill shapes.

    ``buckets=()`` is the escape hatch back to exact-length prefill
    (one compile per distinct prompt length — the seed behaviour, kept
    for parity tests). ``admit_width`` is the fixed batch width of every
    prefill call: admissions sharing a plan are grouped and padded up to
    it, so widths never add compiles beyond ``len(prefill_lengths)`` per
    distinct width.
    """

    cfg: ModelConfig
    max_len: int
    buckets: Optional[Tuple[int, ...]] = None
    admit_width: int = 1
    _buckets: Tuple[int, ...] = field(init=False, repr=False)

    def __post_init__(self):
        if self.buckets is None:
            bk = default_buckets(self.max_len)
        else:
            bk = tuple(sorted(set(int(b) for b in self.buckets)))
            if any(b < 1 or b > self.max_len for b in bk):
                raise ValueError(
                    f"buckets must lie in [1, max_len={self.max_len}]: "
                    f"{bk}")
        if self.admit_width < 1:
            raise ValueError(f"admit_width must be >= 1, "
                             f"got {self.admit_width}")
        object.__setattr__(self, "_buckets", bk)

    # ------------------------------------------------------------------
    @property
    def window(self) -> int:
        """KV window W (the pad cap for sliding-window models)."""
        if self.cfg.sliding_window:
            return min(self.cfg.sliding_window, self.max_len)
        return self.max_len

    @property
    def pad_safe(self) -> bool:
        return self.cfg.family in PAD_SAFE_FAMILIES

    @property
    def prefill_lengths(self) -> Tuple[int, ...]:
        """Every prefill sequence length this scheduler can emit — the
        compile-count bound (per admission width)."""
        if not self._buckets:
            return ()                      # exact mode: unbounded
        lens = set(self._buckets)
        # chunk mode (and its length-1 floor for prompts below the
        # smallest bucket) is only reachable for recurrent families or
        # window-capped padding
        chunk_reachable = not self.pad_safe or bool(self.cfg.sliding_window)
        if chunk_reachable and min(self._buckets) > 1:
            lens.add(1)
        return tuple(sorted(lens))

    def plan(self, prompt_len: int) -> AdmissionPlan:
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if not self._buckets:              # exact mode
            return AdmissionPlan("pad", prompt_len)
        ceil = next((b for b in self._buckets if b >= prompt_len), None)
        if ceil == prompt_len:
            # exact bucket hit: zero padding, safe for every family
            return AdmissionPlan("pad", prompt_len)
        if self.pad_safe and ceil is not None and ceil <= self.window:
            return AdmissionPlan("pad", ceil)
        floor = max((b for b in self._buckets if b <= prompt_len),
                    default=1)
        return AdmissionPlan("chunk", floor)

    def pages_for(self, prompt_len: int, new_tokens: int,
                  page_size: int) -> int:
        """KV pages one request can ever hold, for page-budget admission.

        Capped at the window (mirroring ``models.model._cache_window``):
        a sliding-window cache wraps by design, so a request's live
        pages never exceed ``ceil(W / page_size)`` no matter how long
        the prompt — long prompts the window can serve must be admitted,
        not rejected.
        """
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        tokens = min(prompt_len + new_tokens, self.window)
        return -(-tokens // page_size)

    def max_prefill_compiles(self, n_widths: int = 1) -> int:
        """Upper bound on distinct prefill compilations."""
        return len(self.prefill_lengths) * n_widths
