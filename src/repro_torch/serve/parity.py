"""Teacher-forced logit parity of two runtimes (counterpart of
``repro.serve.parity``), run eagerly.

Both runtimes prefill the same prompts and then decode the same forced
continuation, the *reference* runtime's greedy tokens, so every step
compares logits computed at an identical context. The report carries
the max abs logit deviation, the quantity held to
:data:`~repro_torch.kernels.quant.QUANT_PARITY_TOL`, and the greedy
argmax agreement, which is reported, not asserted: near an argmax tie a
deviation inside the tolerance can still flip the token.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.quant import QUANT_PARITY_TOL
from repro_torch.models.model import (ModelRuntime, cast_params,
                                      check_device, decode_step, prefill)


@dataclass(frozen=True)
class ParityReport:
    """Teacher-forced deviation of one runtime pair over a prompt set."""

    max_logit_dev: float       # max abs logit deviation over every step
    token_match_frac: float    # greedy-argmax agreement over every step
    n_tokens: int              # compared positions (prefill + decode)
    tol: float = QUANT_PARITY_TOL

    @property
    def within_tol(self) -> bool:
        return self.max_logit_dev <= self.tol

    def to_json(self) -> Dict[str, Any]:
        return {
            "max_logit_dev": round(float(self.max_logit_dev), 6),
            "token_match_frac": round(float(self.token_match_frac), 4),
            "n_tokens": int(self.n_tokens),
            "tol": float(self.tol),
            "within_tol": bool(self.within_tol),
        }


def logit_parity(params, cfg: ModelConfig,
                 prompts: Sequence[np.ndarray], *,
                 rt_ref: Optional[ModelRuntime] = None,
                 rt_test: Optional[ModelRuntime] = None,
                 max_new_tokens: int = 8,
                 max_len: Optional[int] = None) -> ParityReport:
    """Measure ``rt_test``'s logit deviation from ``rt_ref``.

    Defaults compare bf16 KV against the int8 cache
    (``ModelRuntime(kv_dtype='int8')``). ``params`` may be f32 master
    weights; each runtime casts them once. Both runtimes must name one
    device.
    """
    rt_ref = rt_ref if rt_ref is not None else ModelRuntime()
    rt_test = rt_test if rt_test is not None \
        else ModelRuntime(kv_dtype="int8")
    if torch.device(rt_ref.device) != torch.device(rt_test.device):
        raise ValueError(f"runtimes on {rt_ref.device} and "
                         f"{rt_test.device}: compare on one device")
    dev = check_device(rt_ref.device)
    rows = [np.asarray(p, np.int32).reshape(-1) for p in prompts]
    if not rows:
        raise ValueError("logit_parity needs at least one prompt")
    B = len(rows)
    S = max(len(p) for p in rows)
    if max_len is None:
        max_len = S + max_new_tokens
    toks = np.zeros((B, S), np.int32)
    lengths = np.zeros((B,), np.int32)
    for i, p in enumerate(rows):
        toks[i, : len(p)] = p
        lengths[i] = len(p)
    toks_t = torch.from_numpy(toks).to(dev)
    lengths_t = torch.from_numpy(lengths).to(dev)

    runs = []
    with torch.no_grad():
        for rt in (rt_ref, rt_test):
            p = cast_params(params, rt)
            cache, logits = prefill(p, cfg, {"tokens": toks_t}, max_len, rt,
                                    lengths=lengths_t)
            runs.append([p, rt, cache, logits])

        max_dev, matches, n = 0.0, 0, 0
        for _ in range(max_new_tokens + 1):
            lr = runs[0][3].float().cpu().numpy()
            lt = runs[1][3].float().cpu().numpy()
            max_dev = max(max_dev, float(np.max(np.abs(lr - lt))))
            matches += int(np.sum(lr.argmax(-1) == lt.argmax(-1)))
            n += B
            forced = torch.from_numpy(lr.argmax(-1).astype(np.int32)).to(dev)
            for run in runs:
                p, rt, cache, _ = run
                run[2], run[3] = decode_step(p, cfg, cache, forced, rt)

    return ParityReport(max_logit_dev=max_dev,
                        token_match_frac=matches / max(n, 1),
                        n_tokens=n)
