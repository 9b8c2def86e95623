"""Pass registry + analysis presets of the port (counterpart of
``repro.analysis.registry``).

An :class:`AnalysisPass` is a named callable ``run(ctx) -> [Finding]``
declaring which rule ids it can emit — the runner uses the declaration
to skip passes entirely when ``--rules`` filters them out.

The port carries five passes: the kernel validator (launch plans of the
Hopper kernels over the tune grids), the contract checker (recipe
resolvability over ``dist.sharding.RECIPES`` among its rules), the
buffer-liveness walk, the repo AST lint and the deployment-feasibility
lint, and the id of the capacity gate behind ``launch/serve.py
--preflight``. The reference's jaxpr lint waits for a compiled step,
and its sharding propagation (over the training recipes, which the
port has since item 12's training half) is still to port (ROADMAP.md
Queue 1 items 12 and 14); its SPMD/compile lint reads XLA's dry-run,
which the port does not have.

Presets: ``ci`` lints the reference ``ci`` preset's two smoke archs at
its ``max_len`` and page size and validates the ``ci`` tune grid;
``h100`` lints every arch that serves on one card at full width, at a
serving ``max_len`` against the card's HBM, and validates the ``h100``
tune grid. Both hold a block to the card's shared memory, 227 KiB.
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
    # kernel validator (launch plans of the Hopper kernels)
    "kernel-grid-coverage": "grid x output tile map must cover every "
                            "output tile",
    "kernel-write-race": "two blocks write one output tile without "
                         "declared accumulation",
    "kernel-smem-budget": "a block's static + dynamic shared memory "
                          "exceeds the 227 KiB opt-in limit, or its "
                          "threads 1,024, or gridDim.y/.z 65,535",
    "kernel-missing-vjp": "non-torch impl is not differentiable: no torch "
                          "reference to borrow a backward pass from, or "
                          "its autograd fails",
    "kernel-dtype-parity": "impl output shapes/dtypes disagree with the "
                           "torch reference",
    "kernel-trace-error": "impl's launch plan fails at a tune-grid shape",
    # contract checker
    "contract-cache-axes": "cache leaf missing from (or rank-mismatched "
                           "with) CACHE_AXES/PAGED_CACHE_AXES",
    "contract-axis-unresolvable": "logical axis name resolves against no "
                                  "sharding recipe (silent replication)",
    "contract-dispatch-ref": "dispatch op without a torch reference impl",
    "contract-tune-grid": "registered impl absent from a tune preset's "
                          "block-size grids (never swept/calibrated)",
    "contract-calib-kind": "dispatch op missing from "
                           "MeasuredModel.CALIB_OP_KIND",
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
    "capacity-spec-drift": "the closed-form capacity model drifted from "
                           "the live runtime/model contracts it mirrors",
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


#: Shared memory a block may opt in to on sm_90 (227 KiB).
SMEM_BUDGET_BYTES = 232448


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
    tune_preset: str = "ci"              # kernels validated at this grid
    smem_budget_bytes: int = SMEM_BUDGET_BYTES
    description: str = ""


#: The archs that serve on one card: every decoder but mixtral-8x22b
#: (~282 GB of bf16 weights); hubert-xlarge is an encoder.
H100_ARCHS = ("minicpm-2b", "qwen2-moe-a2.7b", "mamba2-1.3b", "zamba2-2.7b",
              "chatglm3-6b", "starcoder2-3b", "stablelm-12b", "qwen2-vl-7b")

PRESETS: Dict[str, AnalysisPreset] = {
    "ci": AnalysisPreset(
        name="ci", archs=("minicpm-2b", "mamba2-1.3b"), tune_preset="ci",
        description="dense/SSM smoke configs (seconds)"),
    "h100": AnalysisPreset(
        name="h100", archs=H100_ARCHS, max_len=4096, page_size=16,
        smoke=False, tune_preset="h100",
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
