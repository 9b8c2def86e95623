"""Static analysis of the port (counterpart of ``repro.analysis``):
catch shipped bug classes, broken kernel launches, drifted contracts,
infeasible deployments and HBM overflows *before* anything runs.

    PYTHONPATH=src python -m repro_torch.analysis --preset ci --strict

Eight pass families: the Hopper kernel validator (launch plans over
the tune grids), the hot-path graph lint (the serving steps traced on
``meta`` under the card's policy, each kernel launch one node: host
syncs, trace and cache stability, dtypes, whole-pool int8 upcasts,
prefill compile counts), the contract checker (cache axes, dispatch
closure), the buffer-liveness walk and capacity drift guards, the
shipped-bug-class AST lint over the port and ``chip_smoke.py``, the
deployment-
feasibility lint (scheduler liveness + queueing bounds over the
traffic-scenario library, priced by the one-card model), the sharding
propagation (every recipe over the paper-scale trees on the reference's
production meshes, read from the port's placement) and the SPMD lint
(the dry-run cells' collective bytes and peaks, and a rank's collective
records traced on a ``DryMesh``). Findings
serialize to the port's ``analysis/report.json``
(``repro_torch.artifacts``). The closed-form HBM model behind
``launch/serve.py --preflight`` lives in
:mod:`repro_torch.analysis.capacity`, and its scenario-aware twin
``deploy_preflight`` in :mod:`repro_torch.analysis.deploy_lint`.

The names below load on first use: the kernel dispatch table imports the
validator while the model modules are still importing, so this package
imports nothing of them itself.
"""
import importlib

_EXPORTS = {
    "CapacityReport": "capacity", "serve_preflight": "capacity",
    "DeploymentSpec": "deploy_lint", "DeployReport": "deploy_lint",
    "deploy_preflight": "deploy_lint",
    "Finding": "findings", "Location": "findings", "Report": "findings",
    "apply_suppressions": "findings", "baseline_regressions": "findings",
    "gate_counts": "findings", "load_baseline": "findings",
    "parse_suppressions": "findings",
    "predict_prefill_compiles": "prefill_compiles",
    "PRESETS": "registry", "RULES": "registry",
    "AnalysisContext": "registry", "run_analysis": "runner",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
