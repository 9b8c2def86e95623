"""The port's ``spmd_lint`` pass (``repro_torch.analysis.spmd_lint``):
each of the reference's six rules held to a fixture, as
``tests/test_analysis_perf.py`` holds the reference's — here the
fixtures are a ``DryMesh``'s records (the port's counterpart of XLA's
HLO text), a traced step's host syncs and dry-run artifact cells — and
the pass over the port's ``ci`` census (``python -m
repro_torch.launch.dryrun --preset ci``: 80 cells over both meshes, SKIP
exactly where ``shape_skip_reason`` says; made once a pytest run by
``torch_census``, shared with ``tests/test_torch_dryrun.py``) and over
fresh traces. The census's 64 OK cells are held to the capacity model
under its dry-run calibration, which the reference's recipe refits from
them within the drift bar.
"""
import copy
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import spmd_lint  # noqa: E402
from repro_torch.analysis.capacity import (capacity,  # noqa: E402
                                           capacity_from_artifact)
from repro_torch.analysis.registry import (PRESETS, RULES,  # noqa: E402
                                           AnalysisContext, all_passes)
from repro_torch.analysis.runner import run_analysis  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, shape_skip_reason  # noqa: E402
from repro_torch.launch.lowering import lower_cell  # noqa: E402
from repro_torch.launch.mesh import DryMesh  # noqa: E402
from repro_torch.launch.presets import CI  # noqa: E402

from torch_census import ci_census  # noqa: E402

SPMD_RULES = ("spmd-collective-oversize", "spmd-replicated-gather",
              "spmd-reshard-thrash", "spmd-host-transfer",
              "spmd-memory-drift", "spmd-lowering-skipped")


def _rule_ids(findings):
    return sorted({f.rule_id for f in findings})


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ===========================================================================
# Record fixtures per rule
# ===========================================================================
def gather_records():
    """A 64 MB gather whose result is the whole "parameter tree"."""
    m = DryMesh((1, 16))
    m.all_gather(_meta(1048576, 1), "model", 0)
    return m.records


def thrash_records():
    """The port's reduce-scatter (an all-reduce and a slice) whose slice
    is gathered straight back, then a gather whose result is summed."""
    m = DryMesh((1, 4))
    part = m.all_reduce(_meta(1048576, 8), "model").narrow(0, 0, 262144)
    whole = m.all_gather(part, "model", 0)
    m.all_reduce(whole, "model")
    return m.records


def clean_records():
    """An all-reduce and a gather of an unrelated buffer."""
    m = DryMesh((1, 4))
    m.all_reduce(_meta(128, 256), "model")
    m.all_gather(_meta(8, 16), "model", 0)
    return m.records


def host_syncs():
    """A step that reads a value on the host and copies to the host,
    traced by the graph lint's detector."""
    from repro_torch.analysis.graph_lint import trace

    def step(x):
        n = int(x.sum().item())
        return x.cpu(), n

    g, _, err = trace(step, _meta(128))
    assert err is None
    return [dict(what=w, frame=f, n=n) for (w, f), n in g.syncs.items()]


def test_replicated_gather_fixture_fires_exactly_its_rule():
    param_bytes = 16777216 * 4          # the gather covers 100% of it
    found = spmd_lint.lint_records(gather_records(), [], label="fx",
                                   param_bytes=param_bytes)
    assert _rule_ids(found) == ["spmd-replicated-gather"]
    assert "100%" in found[0].message


def test_replicated_gather_inert_below_param_floor():
    # smoke-scale guard: a sub-MB parameter tree never trips the rule
    assert spmd_lint.find_replicated_gathers(
        gather_records(), param_bytes=200_000) == []


def test_reshard_thrash_fixture_fires_exactly_its_rule():
    recs = thrash_records()
    found = spmd_lint.lint_records(recs, [], label="fx", param_bytes=0)
    assert _rule_ids(found) == ["spmd-reshard-thrash"]
    pairs = spmd_lint.find_reshard_thrash(recs)
    assert [(p["producer"]["index"], p["consumer"]["index"])
            for p in pairs] == [(0, 1), (1, 2)]
    assert [(p["producer"]["kind"], p["consumer"]["kind"])
            for p in pairs] == [("all-reduce", "all-gather"),
                                ("all-gather", "all-reduce")]


def test_host_transfer_fixture_fires_exactly_its_rule():
    syncs = host_syncs()
    assert len(syncs) == 2
    found = spmd_lint.lint_records([], syncs, label="fx", param_bytes=0)
    assert _rule_ids(found) == ["spmd-host-transfer"]
    assert len(found) == 2 and all(f.severity == "error" for f in found)


def test_clean_records_fire_nothing():
    found = spmd_lint.lint_records(clean_records(), [], label="fx",
                                   param_bytes=1 << 30)
    assert found == []


def test_collective_oversize_gate():
    recs = clean_records()
    assert recs[0]["kind"] == "all-reduce"
    assert recs[0]["bytes"] == 128 * 256 * 4
    assert spmd_lint.check_collective_oversize(100.0, 50.0) is None
    over = spmd_lint.check_collective_oversize(400.0, 50.0)
    assert over is not None and over["ratio"] == pytest.approx(8.0)
    # zero expectation never divides-by-zero into a false positive
    assert spmd_lint.check_collective_oversize(1e9, 0.0) is None


# ===========================================================================
# Artifact fixtures
# ===========================================================================
@pytest.fixture(scope="module")
def cell():
    """minicpm-2b/train_4k on the ci single mesh, its peak set to the
    capacity model's (a cell the two gates pass)."""
    art = lower_cell("minicpm-2b", "train_4k", CI.mesh_spec("single"),
                     "single", CI)
    art["memory"]["peak_bytes"] = capacity_from_artifact(art, CI).peak_bytes
    return art


def test_a_consistent_cell_fires_nothing(cell):
    assert spmd_lint.lint_artifact_cell(cell, CI) == []


def test_oversized_artifact_cell_fires_collective_rule(cell):
    bad = copy.deepcopy(cell)
    exp = spmd_lint.expected_collective_bytes(
        CI.arch("minicpm-2b"), CI.shape("train_4k"), bad["mesh_axes"])
    bad["collectives"]["total"] = 7.0 * exp
    found = spmd_lint.lint_artifact_cell(bad, CI)
    assert _rule_ids(found) == ["spmd-collective-oversize"]
    assert "7.0x" in found[0].message


def test_drifted_artifact_cell_fires_memory_rule(cell):
    bad = copy.deepcopy(cell)
    bad["memory"]["peak_bytes"] = int(cell["memory"]["peak_bytes"] * 1.5)
    found = spmd_lint.lint_artifact_cell(bad, CI)
    assert _rule_ids(found) == ["spmd-memory-drift"]


def test_the_traced_cells_move_what_the_ring_model_expects(cell):
    """The ci cell's traced collectives sit inside the reference's slack
    of the analytic expectation (the gate has headroom)."""
    exp = spmd_lint.expected_collective_bytes(
        CI.arch("minicpm-2b"), CI.shape("train_4k"), cell["mesh_axes"])
    assert 0 < cell["collectives"]["total"] <= 6.0 * exp


# ===========================================================================
# The pass
# ===========================================================================
def test_registered_with_the_references_rules():
    assert all_passes()["spmd_lint"].rules == SPMD_RULES
    from repro.analysis.registry import RULES as JRULES
    for r in SPMD_RULES:
        assert RULES[r] == JRULES[r]
    from repro.analysis.registry import PRESETS as JPRESETS
    for name, want in (("ci", "ci"), ("h100", "full")):
        assert PRESETS[name].dryrun_preset == want
    for p in JPRESETS.values():
        assert (spmd_lint.SLACK, spmd_lint.DRIFT_TOL,
                spmd_lint.GATHER_FRAC) == (p.collective_slack,
                                           p.memory_drift_tol,
                                           p.gather_param_frac)


def test_no_artifacts_is_an_info_and_fresh_traces_are_clean(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_ARTIFACT_DIR", str(tmp_path))
    rep = run_analysis("ci", rules=list(SPMD_RULES))
    assert set(rep.passes) == {"spmd_lint"}
    assert [(f.rule_id, f.severity) for f in rep.findings] == \
        [("spmd-lowering-skipped", "info")]
    assert "repro_torch.launch.dryrun --preset ci" in rep.findings[0].message


def test_fresh_traces_of_every_h100_arch_are_clean():
    """Every h100 arch's decode step on the ci single mesh: no host
    transfer (qwen2-moe's expert-parallel layer keeps every routed row,
    a row of another rank's expert computing nothing), no replicated
    gather, no inverse pair."""
    ctx = AnalysisContext(preset=PRESETS["h100"], root=".")
    assert spmd_lint.lint_fresh_traces(ctx) == []


@pytest.mark.parametrize("fused", [False, True])
def test_a_row_of_no_expert_is_left_out_of_every_version(fused):
    """An expert-parallel rank names a row of another rank's expert
    ``n_experts``: the sorted layout leaves it out, its output row is
    zero, and every other row is the plain version's, bit for bit."""
    from repro_torch.kernels import moe_gemm as G
    rng = np.random.default_rng(0)
    E, T, d, f = 3, 40, 16, 8
    x = torch.tensor(rng.standard_normal((T, d)), dtype=torch.float32)
    w = [torch.tensor(rng.standard_normal(s), dtype=torch.float32)
         for s in ((E, d, f), (E, d, f), (E, f, d))]
    eor = torch.tensor(rng.integers(0, E + 1, T), dtype=torch.int32)
    mine = eor < E
    assert 0 < int(mine.sum()) < T
    if fused:
        got = G.moe_gemm_glu(x, *w, eor, torch.mul, n_experts=E)
        h = G.moe_gemm_plain(x, w[0], eor, n_experts=E) \
            * G.moe_gemm_plain(x, w[1], eor, n_experts=E)
        want = G.moe_gemm_plain(h, w[2], eor, n_experts=E)
    else:
        got = G.moe_gemm(x, w[0], eor, n_experts=E)
        want = G.moe_gemm_plain(x, w[0], eor, n_experts=E)
    assert torch.equal(got, want)
    assert not got[~mine].any() and got[mine].abs().sum() > 0


# ===========================================================================
# The ci census, and the pass over it
# ===========================================================================
@pytest.fixture(scope="module")
def census(tmp_path_factory):
    """``python -m repro_torch.launch.dryrun --preset ci``'s 80 cells,
    under an artifact root of their own."""
    return ci_census(tmp_path_factory)


def test_ci_census_has_forty_cells_and_skips_by_the_rule(census):
    """Forty cells a mesh, eighty in all."""
    _, out, results = census
    assert len(results) == 2 * len(ARCHS) * len(SHAPES) == 80
    for r in results:
        skip = shape_skip_reason(CI.arch(r["arch"]), CI.shape(r["shape"]))
        assert r["status"] == ("SKIP" if skip else "OK"), r
        if skip:
            assert r["reason"] == skip
    names = sorted(n for n in os.listdir(out) if not n.startswith("_"))
    assert len(names) == 80
    assert sum(n.endswith("__multi.json") for n in names) == 40
    manifest = json.load(open(out / "_manifest.json"))
    assert manifest["cells"] == 80 and manifest["counts"]["FAIL"] == 0
    assert manifest["meshes"]["single"] == {"shape": [2, 4], "axes": [
        "data", "model"], "devices": 8}
    assert manifest["meshes"]["multi"] == {"shape": [2, 2, 2], "axes": [
        "pod", "data", "model"], "devices": 8}


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-1.3b"])
def test_ci_analysis_archs_trace_every_shape(census, arch):
    _, out, _ = census
    for shape in SHAPES:
        art = json.load(open(out / f"{arch}__{shape}__single.json"))
        if shape_skip_reason(CI.arch(arch), CI.shape(shape)):
            continue
        assert art["status"] == "OK"
        for key in ("memory", "cost", "collectives", "roofline", "workload"):
            assert key in art
        mem = art["memory"]
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
        assert art["cost"]["flops"] > 0
        assert art["collectives"]["total"] > 0
        assert art["roofline"]["dominant"] in ("compute_s", "memory_s",
                                               "collective_s")
        assert art["devices"] == 8 and art["trace_s"] >= 0
        # a rank's argument bytes are the capacity model's exactly
        rep = capacity(CI.arch(arch), CI.shape(shape),
                       mesh=art["mesh_axes"])
        assert mem["argument_bytes"] == rep.argument_bytes


def test_the_pass_reads_the_ports_ci_cells(census, monkeypatch):
    """Over the 64 OK ci cells of both meshes: no collective oversize,
    and every peak within ``DRIFT_TOL`` of the capacity model under its
    dry-run calibration; the fresh traces are clean: no finding."""
    root, _, results = census
    monkeypatch.setenv("REPRO_TORCH_ARTIFACT_DIR", str(root))
    ok = {f"{r['arch']}/{r['shape']}/{r['mesh']}" for r in results
          if r["status"] == "OK"}
    assert len(ok) == 64
    rep = run_analysis("ci", rules=list(SPMD_RULES))
    assert [(f.rule_id, f.location.symbol) for f in rep.findings] == []


def test_the_dry_run_calibration_is_the_census_fit(census, capsys):
    """The reference's recipe (nnls weighted by relative error, through
    ``analysis.capacity_fit``) refit from the census gives the pinned
    ``DRYRUN_CALIBRATION`` within a rounding step, and under it each
    kind's worst error stays within the drift bar (printed per kind, as
    the reference's docstring gives its 6.4 / 7.1 / 9.4 %)."""
    from repro_torch.analysis import capacity_fit
    from repro_torch.analysis.capacity import (DRYRUN_CALIBRATION,
                                               DRYRUN_FEATURES)
    _, out, _ = census
    records = capacity_fit.dryrun_records(str(out))
    assert len(records) == 64
    worst = {}
    for kind, feats in DRYRUN_FEATURES.items():
        rows = [r for r in records if r["kind"] == kind]
        fitted = capacity_fit.fit(rows, feats)
        want = DRYRUN_CALIBRATION[kind]
        assert set(fitted) == set(want), kind
        for k, c in want.items():
            assert fitted[k] == pytest.approx(c, rel=1e-3, abs=1e-3), (kind, k)
        worst[kind] = max(capacity_fit.rel_errors(rows, want))
        assert worst[kind] <= spmd_lint.DRIFT_TOL, (kind, worst[kind])
    with capsys.disabled():
        print("\n[spmd_lint] dry-run calibration, worst |walk - model| / "
              "walk: " + ", ".join(f"{k} {v:.2%}" for k, v in worst.items()))
