"""The port stands alone: it imports neither JAX nor the reference
package, and its kernel builder refuses to run without ``nvcc``."""
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"

_CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(",".join(mods))
print(len(mods), bad)
"""

#: Modules the walk must reach: the trace front-end, the figures, the
#: examples and the last-ported families' configs among them.
_NEW = ("repro_torch.core.workload.torch_trace",
        "repro_torch.configs.chatglm3_6b",
        "repro_torch.configs.starcoder2_3b",
        "repro_torch.configs.stablelm_12b",
        "repro_torch.configs.qwen2_vl_7b",
        "repro_torch.configs.hubert_xlarge",
        "repro_torch.bench.figures.__main__",
        "repro_torch.bench.figures.common",
        "repro_torch.bench.figures.fig4_pipeline_model_error",
        "repro_torch.bench.figures.fig5_generic_model_error",
        "repro_torch.bench.figures.fig6_ctc",
        "repro_torch.bench.figures.fig8_dsp_efficiency",
        "repro_torch.bench.figures.fig9_resource_split",
        "repro_torch.bench.figures.fig10_scalability",
        "repro_torch.bench.figures.fig11_dse_convergence",
        "repro_torch.examples.quickstart",
        "repro_torch.examples.explore_accelerator")


def test_port_imports_without_jax_or_reference():
    env_src = str(PKG.parent)
    out = subprocess.run([sys.executable, "-c", _CHECK], capture_output=True,
                         text=True, env={"PYTHONPATH": env_src,
                                         "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    names, counts = out.stdout.strip().splitlines()[-2:]
    n, bad = counts.split(" ", 1)
    assert int(n) >= 15
    assert bad == "[]", bad
    assert set(_NEW) <= set(names.split(","))


def test_port_sources_name_no_reference_import():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\.|"
                     r"from repro[. ]|import repro$)", re.M)
    hits = [str(p) for p in PKG.rglob("*.py") if pat.search(p.read_text())]
    assert hits == []


def test_builder_raises_without_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library(tmp_path / "out")
    assert not list((tmp_path / "out").glob("*/*.so"))


def test_builder_surfaces_compile_errors(tmp_path):
    """A failing nvcc raises with its stderr; nothing is published."""
    from repro_torch.kernels import _build
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: bad kernel' >&2\nexit 2\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build_library(tmp_path / "out", nvcc=str(fake))
    assert not list((tmp_path / "out").glob("*/*.so"))
