"""How many prefill shapes serving a set of prompt lengths costs: the
static twin of ``EngineStats.prefill_compiles``.

The reference's ``repro.analysis.jaxpr_lint.predict_prefill_compiles``,
which is pure Python: a replay of ``Scheduler.plan``. The port's engine
runs eagerly and has no traces, but counts each distinct prefill call
shape ``(prefill_len, width)`` once (``serve/engine.py``
``EngineStats.prefill_traces``), so the same count predicts it. The
rest of ``jaxpr_lint`` scans jaxprs; its counterpart, which traces the
serving steps on ``meta``, is :mod:`repro_torch.analysis.graph_lint`
(``graph-compile-count`` calls this).
"""
from __future__ import annotations

from typing import Iterable, Sequence


def predict_prefill_compiles(scheduler, prompt_lens: Iterable[int],
                             widths: Sequence[int] = (1,)) -> int:
    """Distinct prefill shapes serving ``prompt_lens`` costs.

    The engine keys its counter on the prefill call shape
    ``(prefill_len, width)``; this replays ``Scheduler.plan`` over the
    same lengths and counts the distinct keys — equal to the measured
    counter, since every prefill call runs at the scheduler's
    ``admit_width``.
    """
    keys = set()
    for n in prompt_lens:
        plan = scheduler.plan(int(n))
        for w in widths:
            keys.add((plan.prefill_len, int(w)))
    return len(keys)
