"""Where the port writes what it generates.

    <root>/kernels/calibration.json     the tuner's calibration
    <root>/bench/<name>.json            benchmark outputs
    <root>/analysis/report.json         static-analysis findings
    <root>/dryrun/<preset>/<arch>__<shape>__<mesh>.json
                                        a dry-run cell (launch.dryrun)
    <root>/dryrun/<preset>/_manifest.json   the sweep's geometry

``<root>`` is ``$REPRO_TORCH_ARTIFACT_DIR`` when set, else
``./artifacts/torch`` relative to the working directory. The port never
writes the reference's ``artifacts/kernels/calibration.json`` (the two
tuners time different implementations on different devices), its
``artifacts/analysis/`` nor its ``artifacts/dryrun/`` (XLA's cells for
TPU meshes, where the port's are traces for meshes of cards). The helpers are functions, so the variable is
read at call time.
"""
from __future__ import annotations

import os

ENV_VAR = "REPRO_TORCH_ARTIFACT_DIR"


def artifact_root() -> str:
    """Absolute root: ``$REPRO_TORCH_ARTIFACT_DIR`` or
    ``./artifacts/torch``."""
    return os.path.abspath(os.environ.get(ENV_VAR) or os.path.join(
        os.getcwd(), "artifacts", "torch"))


def kernels_dir() -> str:
    """The tuner's artifacts (``repro_torch.kernels.tune``)."""
    return os.path.join(artifact_root(), "kernels")


def calibration_path() -> str:
    """The calibration the measured model
    (``repro_torch.core.analytical.measured``) prices workloads from."""
    return os.path.join(kernels_dir(), "calibration.json")


def bench_dir() -> str:
    """Benchmark outputs (``repro_torch.bench``)."""
    return os.path.join(artifact_root(), "bench")


def analysis_dir() -> str:
    """Static-analysis artifacts (``repro_torch.analysis``)."""
    return os.path.join(artifact_root(), "analysis")


def analysis_report_path() -> str:
    """The findings report ``python -m repro_torch.analysis`` writes."""
    return os.path.join(analysis_dir(), "report.json")


def analysis_baseline_path() -> str:
    """Where ``python -m repro_torch.analysis --write-baseline`` keeps a
    gate-count baseline for ``--baseline`` to diff against."""
    return os.path.join(analysis_dir(), "baseline.json")


MANIFEST_NAME = "_manifest.json"


def dryrun_dir(preset: str) -> str:
    """A dry-run preset's cell directory (not created)."""
    return os.path.join(artifact_root(), "dryrun", preset)


def manifest_path(preset: str) -> str:
    return os.path.join(dryrun_dir(preset), MANIFEST_NAME)


def cell_path(preset: str, arch: str, shape: str, mesh: str) -> str:
    return os.path.join(dryrun_dir(preset), f"{arch}__{shape}__{mesh}.json")


def list_cells(preset: str) -> list:
    """Cell artifact filenames of ``preset`` (the manifest excluded)."""
    d = dryrun_dir(preset)
    if not os.path.isdir(d):
        return []
    return sorted(n for n in os.listdir(d)
                  if n.endswith(".json") and not n.startswith("_"))
