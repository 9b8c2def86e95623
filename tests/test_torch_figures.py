"""The paper's figures and the two examples from the port, on the CPU.

Each figure of ``repro_torch.bench.figures`` runs beside the reference's
``benchmarks.<fig>.run()`` with the reference runner's quick arguments:
the summary each returns and the rows each writes must agree to 1e-12
relative (fig11's seeded DSE traces point for point). The runner and
both examples run as subprocesses.
"""
import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REL = 1e-12

#: (name, module, args, kwargs) of the reference runner's --quick roster
QUICK = (("fig4", "fig4_pipeline_model_error", (), {}),
         ("fig5", "fig5_generic_model_error", (), {}),
         ("fig6", "fig6_ctc", (), {}),
         ("fig8", "fig8_dsp_efficiency", (6,), {}),
         ("fig9", "fig9_resource_split", (6,), {}),
         ("fig10", "fig10_scalability", (), {}),
         ("fig11", "fig11_dse_convergence", (),
          {"n_particles": 12, "n_iters": 12}))


def _same(got, want, where="") -> None:
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert math.isclose(float(got), want, rel_tol=REL, abs_tol=1e-300), \
            (where, got, want)
    else:
        assert got == want, (where, got, want)


def test_runner_roster_matches_reference(monkeypatch):
    from repro_torch.bench.figures.__main__ import build_benches
    monkeypatch.syspath_prepend(str(REPO))
    from benchmarks.run import build_benches as jbuild
    want = [b for b in jbuild(quick=True) if b[0] in {q[0] for q in QUICK}]
    got = build_benches(quick=True)
    assert [b[0] for b in got] == [q[0] for q in QUICK]
    assert [(b[0], b[1], b[3], b[4]) for b in got] == \
        [(b[0], b[1], b[3], b[4]) for b in want]
    assert [(q[0], q[1], q[2], q[3]) for q in QUICK] == \
        [(b[0], b[1], b[3], b[4]) for b in got]


@pytest.mark.parametrize("name,mod,args,kwargs", QUICK,
                         ids=[q[0] for q in QUICK])
def test_figure_rows_equal_reference(name, mod, args, kwargs, tmp_path,
                                     monkeypatch):
    monkeypatch.setenv("REPRO_ARTIFACT_DIR", str(tmp_path / "ref"))
    monkeypatch.setenv("REPRO_TORCH_ARTIFACT_DIR", str(tmp_path / "port"))
    monkeypatch.syspath_prepend(str(REPO))
    ref = importlib.import_module(f"benchmarks.{mod}")
    port = importlib.import_module(f"repro_torch.bench.figures.{mod}")
    want = ref.run(*args, **kwargs)
    got = port.run(*args, **kwargs)
    _same(got, want, name)
    assert bool(got["pass"])
    rows = [json.loads((tmp_path / side / "bench" / f"{mod}.json")
                       .read_text()) for side in ("ref", "port")]
    assert rows[0]
    _same(rows[1], rows[0], name)
    if name == "fig11":
        assert [r["trace"] for r in rows[1]] == [r["trace"] for r in rows[0]]


def _run(*args, env=None, timeout=300):
    return subprocess.run([sys.executable, "-m", *args],
                          capture_output=True, text=True, cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin", **(env or {})},
                          timeout=timeout)


def test_runner_lists_and_runs_one_figure(tmp_path):
    out = _run("repro_torch.bench.figures", "--list")
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [q[0] for q in QUICK]
    art, ref = tmp_path / "art", tmp_path / "ref"
    out = _run("repro_torch.bench.figures", "--only", "fig6",
               env={"REPRO_TORCH_ARTIFACT_DIR": str(art),
                    "REPRO_ARTIFACT_DIR": str(ref)})
    assert out.returncode == 0, out.stderr
    payload = json.loads((art / "bench" / "results.json").read_text())
    assert payload["ran"] == ["fig6"] and payload["only"] == ["fig6"]
    assert payload["pass"] is True and payload["quick"] is False
    assert payload["available"] == [q[0] for q in QUICK]
    assert payload["benchmarks"]["fig6"]["median_growth"] == 256.0
    assert (art / "bench" / "fig6_ctc.json").exists()
    assert not ref.exists()         # never the reference's bench dir
    out = _run("repro_torch.bench.figures", "--only", "fig7",
               env={"REPRO_TORCH_ARTIFACT_DIR": str(art)})
    assert out.returncode == 2 and "unknown figure" in out.stderr


def test_quickstart_runs_on_cpu(tmp_path):
    out = _run("repro_torch.examples.quickstart", "--device", "cpu",
               env={"REPRO_TORCH_ARTIFACT_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    for step in ("step 1-2", "step 3", "step 4"):
        assert step in out.stdout
    assert "traced profile" in out.stdout
    assert "from measured kernel timings" in out.stdout


def test_explore_accelerator_runs(tmp_path):
    out = _run("repro_torch.examples.explore_accelerator",
               env={"REPRO_TORCH_ARTIFACT_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert "Fig. 10" in out.stdout and "Fig. 11" in out.stdout
    assert out.stdout.count("traced  :") == 3
