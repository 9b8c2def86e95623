"""Static analysis of the port (counterpart of ``repro.analysis``):
catch shipped bug classes, infeasible deployments and HBM overflows
*before* anything runs.

    PYTHONPATH=src python -m repro_torch.analysis --preset ci --strict

Two pass families: the shipped-bug-class AST lint over the port and
``chip_smoke.py``, and the deployment-feasibility lint (scheduler
liveness + queueing bounds over the traffic-scenario library, priced
by the one-card model). Findings serialize to the port's
``analysis/report.json`` (``repro_torch.artifacts``). The closed-form
HBM model behind ``launch/serve.py --preflight`` lives in
:mod:`repro_torch.analysis.capacity`, and its scenario-aware twin
``deploy_preflight`` in :mod:`repro_torch.analysis.deploy_lint`.
"""
from repro_torch.analysis.capacity import (CapacityReport, capacity,
                                           serve_preflight)
from repro_torch.analysis.deploy_lint import (DeploymentSpec, DeployReport,
                                              deploy_preflight)
from repro_torch.analysis.findings import (Finding, Location, Report,
                                           apply_suppressions,
                                           baseline_regressions,
                                           gate_counts, load_baseline,
                                           parse_suppressions)
from repro_torch.analysis.prefill_compiles import predict_prefill_compiles
from repro_torch.analysis.registry import PRESETS, RULES, AnalysisContext
from repro_torch.analysis.runner import run_analysis

__all__ = [
    "Finding", "Location", "Report", "apply_suppressions",
    "parse_suppressions", "PRESETS", "RULES", "AnalysisContext",
    "run_analysis", "capacity", "CapacityReport", "serve_preflight",
    "gate_counts", "load_baseline", "baseline_regressions",
    "deploy_preflight", "DeploymentSpec", "DeployReport",
    "predict_prefill_compiles",
]
