"""Pass registry + analysis presets of the port (counterpart of
``repro.analysis.registry``).

An :class:`AnalysisPass` is a named callable ``run(ctx) -> [Finding]``
declaring which rule ids it can emit — the runner uses the declaration
to skip passes entirely when ``--rules`` filters them out.

The port carries the passes it has: the repo AST lint and the
deployment-feasibility lint, and the id of the capacity gate behind
``launch/serve.py --preflight``. The reference's kernel validator, jaxpr
lint, contract checker, SPMD lint, liveness walk and sharding
propagation have no counterpart yet (ROADMAP.md Queue 1 item 14).

Presets: ``ci`` lints the reference ``ci`` preset's two smoke archs at
its ``max_len`` and page size; ``h100`` lints every arch that serves on
one card at full width, at a serving ``max_len`` against the card's HBM.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

from repro_torch.analysis.findings import Finding

# ---------------------------------------------------------------------------
# Rule catalog (id -> one-line description), the single source for
# --list-rules; the reference's text.
# ---------------------------------------------------------------------------
RULES: Dict[str, str] = {
    # repo AST lint (shipped bug classes)
    "ast-salted-hash": "builtin hash() on a persisted/cross-process key "
                       "(PYTHONHASHSEED makes it per-process)",
    "ast-env-mutation": "import-time os.environ/XLA_FLAGS mutation "
                        "outside a __main__ guard",
    "ast-axis-shape-guess": "axis identified by .shape[i] == comparison "
                            "(collides as soon as two dims agree)",
    # capacity
    "capacity-hbm-overflow": "predicted per-device peak HBM exceeds the "
                             "chip budget (the --preflight gate)",
    # deployment feasibility (scenario library x serving config)
    "deploy-admission-deadlock": "a request shape within max_len needs "
                                 "more pages than the pool holds: the "
                                 "head-of-line wait never resolves",
    "deploy-bucket-gap": "scenario prompt lengths with no admissible "
                         "prefill plan, or chunk mode forcing most "
                         "prompt tokens through one-token decode",
    "deploy-compile-unbounded": "whole-deployment prefill-compile "
                                "inventory (buckets x admit widths x kv "
                                "dtypes) exceeds or lacks a static bound",
    "deploy-slo-infeasible": "rho >= 1 or a latency lower bound beats "
                             "the SLO at every admissible batch — no "
                             "schedule can rescue the config",
    "deploy-queue-saturation": "stable at the mean arrival rate but past "
                               "the saturation knee at the scenario's "
                               "peak rate (M/G/1 wait bound)",
    "deploy-capacity-overflow": "deployment allocation or scenario "
                                "concurrency demand exceeds per-device "
                                "HBM (closed-form, jax-free)",
    # infrastructure
    "analysis-suppression": "ignore[...] comment without a justification",
    "analysis-pass-error": "an analysis pass itself crashed",
}


@dataclass(frozen=True)
class AnalysisPreset:
    """Scale point of one analysis run: the archs linted (their smoke
    configs when ``smoke``), and the serving ``max_len`` and page size
    they are linted at."""

    name: str
    archs: Tuple[str, ...]
    max_len: int = 64
    page_size: int = 8
    smoke: bool = True
    description: str = ""


#: The archs that serve on one card: every decoder but mixtral-8x22b
#: (~282 GB of bf16 weights); hubert-xlarge is an encoder.
H100_ARCHS = ("minicpm-2b", "qwen2-moe-a2.7b", "mamba2-1.3b", "zamba2-2.7b",
              "chatglm3-6b", "starcoder2-3b", "stablelm-12b", "qwen2-vl-7b")

PRESETS: Dict[str, AnalysisPreset] = {
    "ci": AnalysisPreset(
        name="ci", archs=("minicpm-2b", "mamba2-1.3b"),
        description="dense/SSM smoke configs (seconds)"),
    "h100": AnalysisPreset(
        name="h100", archs=H100_ARCHS, max_len=4096, page_size=16,
        smoke=False,
        description="every arch that serves on one card, full width"),
}


@dataclass
class AnalysisContext:
    """Everything a pass needs: the preset + the tree root to lint."""

    preset: AnalysisPreset
    root: str


@dataclass(frozen=True)
class AnalysisPass:
    name: str
    rules: Tuple[str, ...]
    run: Callable[[AnalysisContext], List[Finding]]
    description: str = ""


_PASSES: Dict[str, AnalysisPass] = {}


def register_pass(name: str, rules: Tuple[str, ...], description: str = ""):
    """Decorator: register ``fn(ctx) -> [Finding]`` under ``name``."""
    unknown = [r for r in rules if r not in RULES]
    if unknown:
        raise KeyError(f"pass {name!r} declares unknown rules {unknown}; "
                       f"add them to registry.RULES")

    def deco(fn):
        _PASSES[name] = AnalysisPass(name, tuple(rules), fn, description)
        return fn

    return deco


def all_passes() -> Dict[str, AnalysisPass]:
    return dict(_PASSES)
