"""The port's static twin of serving against the reference, on the CPU.

* ``serve/scenarios.py`` — the copy equal to ``repro.serve.scenarios``:
  the four scenarios, ``scaled``, ``sample_requests``, the moments and
  the JSON round trip;
* ``analysis/capacity.py`` — the argument model byte for byte against
  what the port's ``init_params``/``init_cache``/``init_paged_cache`` and
  ``PagedServeEngine`` allocate, for every family, contiguous and paged,
  bf16 and int8 KV; equal to the reference's ``argument_bytes`` where
  the dtypes agree; the peak formula under the reference's (XLA's)
  coefficients equal to its ``peak_bytes``; a mesh priced per device
  for every family;
* ``analysis/deploy_lint.py`` — ``deploy_preflight`` equal to the
  reference's under ``H100_AS_TPU`` (the reference's chip vocabulary
  carrying the H100's numbers) for every arch and scenario at smoke
  size, to ``REL``; the six rules fired by the reference's fixtures;
* ``predict_prefill_compiles`` against the port engine's counter; the
  AST lint and the CLI (exit codes, ``--list-rules``, a fixture firing
  one exact rule, the clean ``ci`` tree, no ``jax``/``repro.`` import).
"""
import importlib
import json
import math
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.core.hardware import TPUSpec  # noqa: E402
from repro.serve import scenarios as jscen  # noqa: E402

from repro_torch.analysis.ast_lint import (lint_source,  # noqa: E402
                                           target_files)
from repro_torch.analysis.deploy_lint import (FIXTURE_ENV,  # noqa: E402
                                              RULE_IDS, DeploymentSpec,
                                              default_deployment,
                                              deploy_preflight)
from repro_torch.analysis.prefill_compiles import (  # noqa: E402
    predict_prefill_compiles)
from repro_torch.analysis.registry import (PRESETS, RULES,  # noqa: E402
                                           AnalysisContext)
from repro_torch.analysis.runner import run_analysis  # noqa: E402
from repro_torch.configs import ARCHS, get_arch, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.hardware import H100_SXM  # noqa: E402
from repro_torch.models import (ModelRuntime, init_cache,  # noqa: E402
                                init_paged_cache, init_params)
from repro_torch.serve import (PagedServeEngine, Request,  # noqa: E402
                               Scheduler, ServeEngine)
from repro_torch.serve import scenarios as scen  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

# the packages export a function named ``capacity``: fetch the modules
cap = importlib.import_module("repro_torch.analysis.capacity")
deploy = importlib.import_module("repro_torch.analysis.deploy_lint")
jcap = importlib.import_module("repro.analysis.capacity")
jdeploy = importlib.import_module("repro.analysis.deploy_lint")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Float results of the closed-form models against the reference's.
REL = 1e-12
#: The reference's chip vocabulary carrying the H100's numbers.
H100_AS_TPU = TPUSpec(name=H100_SXM.name,
                      peak_flops_bf16=H100_SXM.peak_flops_bf16,
                      peak_flops_int8=H100_SXM.peak_flops_int8,
                      hbm_bytes=H100_SXM.hbm_bytes, hbm_bw=H100_SXM.hbm_bw)
ARCH_IDS = tuple(ARCHS)
DECODERS = tuple(a for a in ARCH_IDS if not ARCHS[a].is_encoder_only)
KV_DTYPES = (None, "bfloat16", "int8")


def _cfgs(arch):
    return smoke_config(get_arch(arch)), jsmoke(jget_arch(arch))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _close(got, want):
    assert math.isclose(float(got), float(want), rel_tol=REL,
                        abs_tol=1e-300), (got, want)


# ===========================================================================
# Scenario library: the copy equals the reference
# ===========================================================================
@pytest.mark.parametrize("name", sorted(jscen.SCENARIOS))
def test_scenario_copy_matches_reference(name):
    ours, ref = scen.SCENARIOS[name], jscen.SCENARIOS[name]
    assert ours.to_json() == ref.to_json()
    assert scen.Scenario.from_json(ours.to_json()) == ours
    assert ours.max_context() == ref.max_context()
    for max_len in (64, 256, 1024, 10_000):
        assert ours.scaled(max_len).to_json() == ref.scaled(max_len).to_json()
    for seed in (0, 7):
        assert ours.sample_requests(24, seed=seed) == \
            ref.sample_requests(24, seed=seed)
    for dist, jdist in ((ours.prompt_lens, ref.prompt_lens),
                        (ours.output_lens, ref.output_lens)):
        assert dist.mean == jdist.mean and dist.weights == jdist.weights
        for q in (0.0, 0.5, 0.99, 1.0):
            assert dist.quantile(q) == jdist.quantile(q)
        assert dist.scaled(0.3).points == jdist.scaled(0.3).points
    assert ours.arrival.peak_rps == ref.arrival.peak_rps
    assert set(scen.SCENARIOS) == set(jscen.SCENARIOS)
    assert scen.get_scenario(name) == ours
    with pytest.raises(KeyError, match="known"):
        scen.get_scenario("no_such_traffic")


@pytest.mark.parametrize("process", ["poisson", "burst", "diurnal"])
def test_arrival_processes_match_reference(process):
    a = scen.ArrivalSpec(rate_rps=4.0, process=process, peak_factor=2.0)
    b = jscen.ArrivalSpec(rate_rps=4.0, process=process, peak_factor=2.0)
    assert a.interarrivals(40, np.random.default_rng(3)) == \
        b.interarrivals(40, np.random.default_rng(3))
    with pytest.raises(ValueError):
        scen.ArrivalSpec(4.0, process="bogus")
    with pytest.raises(ValueError):
        scen.LengthDist(((0, 1.0),))


# ===========================================================================
# Capacity: the exact argument model against the port's allocations
# ===========================================================================
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_params_bytes_equal_allocation(arch, dtype):
    cfg = smoke_config(get_arch(arch))
    rt = ModelRuntime(dtype=dtype, device="cpu")
    params = init_params(cfg, seed=0, device="cpu", rt=rt)
    assert cap.params_bytes(cfg, dtype) == _nbytes(params)


@pytest.mark.parametrize("arch", DECODERS)
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_cache_bytes_equal_allocation(arch, kv_dtype):
    """Contiguous and paged (the engine's own page budget), bf16 runtime:
    the report's cache and argument bytes are what is allocated."""
    cfg = smoke_config(get_arch(arch))
    n_slots, max_len, ps = 3, 48, 8
    rep = cap.serve_preflight(cfg, n_slots=n_slots, max_len=max_len,
                              kv_dtype=kv_dtype)
    cache = init_cache(cfg, n_slots, max_len, "bfloat16", kv_dtype,
                       device="cpu")
    assert rep.cache_bytes == _nbytes(cache)
    assert rep.argument_bytes == (cap.params_bytes(cfg, "bfloat16")
                                  + _nbytes(cache) + 4 * n_slots)
    prep = cap.serve_preflight(cfg, n_slots=n_slots, max_len=max_len,
                               page_size=ps, kv_dtype=kv_dtype)
    n_pages = cap.default_page_budget(cfg, n_slots, max_len, ps,
                                      "bfloat16", kv_dtype)
    pool = init_paged_cache(cfg, n_slots, n_pages, ps, max_len, "bfloat16",
                            kv_dtype, device="cpu")
    assert prep.cache_bytes == _nbytes(pool)
    assert prep.kind == "decode" and prep.argument_bytes <= prep.peak_bytes


@pytest.mark.parametrize("arch", ["minicpm-2b", "zamba2-2.7b",
                                  "qwen2-moe-a2.7b", "mamba2-1.3b"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_preflight_gates_the_engines_pool(arch, kv_dtype):
    """The paged preflight derives the pool ``PagedServeEngine`` builds,
    and both engines hold exactly the predicted parameters and cache."""
    cfg = smoke_config(get_arch(arch))
    rt = ModelRuntime(dtype="float32", device="cpu", kv_dtype=kv_dtype)
    params = init_params(cfg, seed=0, device="cpu")
    for page_size in (0, 8):
        rep = cap.serve_preflight(cfg, n_slots=3, max_len=40,
                                  page_size=page_size or None,
                                  dtype="float32", kv_dtype=kv_dtype)
        if page_size:
            eng = PagedServeEngine(params, cfg, rt, n_slots=3, max_len=40,
                                   page_size=page_size)
            assert eng.n_pages == cap.default_page_budget(
                cfg, 3, 40, page_size, "float32", kv_dtype)
        else:
            eng = ServeEngine(params, cfg, rt, n_slots=3, max_len=40)
        assert rep.params_bytes == _nbytes(eng.params)
        assert rep.cache_bytes == _nbytes(eng.cache)


def _ref_pair(arch, form, kv_dtype):
    """(port report, reference report) where the dtypes agree: f32
    parameters, the cache's activation leaves in bf16 (the reference's
    ``cache_spec`` default)."""
    cfg, jcfg = _cfgs(arch)
    kw = dict(param_dtype="float32", kv_dtype=kv_dtype)
    if form in ("contiguous", "paged"):
        skw = dict(n_slots=3, max_len=40)
        if form == "paged":
            skw.update(page_budget=17, page_size=8)
        return (cap.capacity(cfg, dtype="bfloat16", **skw, **kw),
                jcap.capacity(jcfg, **skw, **kw))
    B, S = (2, 24) if form == "train" else (1, 32)
    return (cap.capacity(cfg, ShapeConfig(form, S, B, form),
                         dtype="bfloat16", **kw),
            jcap.capacity(jcfg, JShape(form, S, B, form), **kw))


#: (arch, form): the serving forms for decoders only (an encoder has no
#: decode cache).
FORMS = tuple((a, f) for f in ("contiguous", "paged", "prefill", "train")
              for a in ARCH_IDS if f in ("prefill", "train") or a in DECODERS)


@pytest.mark.parametrize("arch,form", FORMS)
def test_argument_bytes_match_reference(arch, form):
    cfg = smoke_config(get_arch(arch))
    for kv in KV_DTYPES if form in ("contiguous", "paged") else (None,):
        ours, ref = _ref_pair(arch, form, kv)
        extra = 0
        if form == "prefill" and cfg.frontend != "token":
            # the port holds the token table; the reference's XLA prunes it
            extra = cfg.vocab_size * cfg.d_model * 4
        assert ours.argument_bytes == ref.argument_bytes + extra
        assert ours.params_bytes == ref.params_bytes + extra
        assert ours.cache_bytes == ref.cache_bytes
        assert ours.batch_bytes == ref.batch_bytes


@pytest.mark.parametrize("arch,form", [
    (a, f) for a, f in FORMS
    # a non-token prefill's argument floor holds the token table (above)
    if f != "prefill" or ARCHS[a].frontend == "token"])
def test_peak_formula_matches_reference_under_xla_coefficients(arch, form):
    for kv in KV_DTYPES if form in ("contiguous", "paged") else (None,):
        ours, ref = _ref_pair(arch, form, kv)
        for k, v in ref.features.items():
            _close(ours.features[k], v)
        coef = cap.XLA_CALIBRATION[ours.kind]
        assert coef == ref.coefficients
        assert cap.predicted_peak(ours.features, coef,
                                  ours.argument_bytes) == ref.peak_bytes


def test_card_calibration_covers_its_features():
    for kind, coef in cap.CALIBRATION.items():
        assert set(coef) <= set(cap.FIT_FEATURES[kind])
        assert all(c >= 0 for c in coef.values())
    assert cap.PARITY_REL_TOL == jcap.PARITY_REL_TOL == 0.25
    assert cap.XLA_CALIBRATION == jcap.CALIBRATION


def test_mesh_priced_for_every_family_and_one_device_accepted():
    """A mesh is priced per device for every family (pure shape math;
    ``tests/test_torch_sharding.py`` holds the bytes to the reference's):
    the SSM's state at its heads, the MoE's experts a rank; one device
    is the default."""
    cfg = smoke_config(get_arch("minicpm-2b"))
    ssm = smoke_config(get_arch("mamba2-1.3b"))
    moe = smoke_config(get_arch("qwen2-moe-a2.7b"))
    for mesh in ({"data": 2, "model": 1}, {"data": 1, "model": 4}):
        rep = cap.serve_preflight(cfg, n_slots=2, max_len=32, mesh=mesh)
        assert rep.mesh_sizes == mesh
        assert rep.devices == mesh["data"] * mesh["model"]
        assert DeploymentSpec(mesh=mesh).mesh == mesh
        assert deploy_preflight(cfg, "chat_burst", mesh=mesh).mesh == mesh
        for c in (ssm, moe):
            one = cap.serve_preflight(c, n_slots=2, max_len=32)
            rep = cap.serve_preflight(c, n_slots=2, max_len=32, mesh=mesh)
            assert rep.mesh_sizes == mesh
            assert rep.cache_bytes < one.cache_bytes
            assert (rep.params_bytes < one.params_bytes) == \
                (mesh["model"] > 1)
    one = cap.serve_preflight(cfg, n_slots=2, max_len=32,
                              mesh={"data": 1, "model": 1})
    assert one == cap.serve_preflight(cfg, n_slots=2, max_len=32)


def test_budget_and_hbm_gb_gate():
    cfg = get_arch("stablelm-12b")              # full width: pure math
    rep = cap.serve_preflight(cfg, n_slots=64, max_len=8192)
    assert rep.hbm_bytes == int(H100_SXM.hbm_bytes) and not rep.fits
    # K/V alone: 40 layers x 8 heads x 160 x 2 x 2 B a token
    assert rep.cache_bytes >= 64 * 8192 * 40 * 8 * 160 * 2 * 2
    small = cap.serve_preflight(get_arch("minicpm-2b"), n_slots=4,
                                max_len=1024, page_size=16, hbm_gb=4)
    assert small.hbm_bytes == 4 * 2**30 and not small.fits
    assert cap.serve_preflight(get_arch("minicpm-2b"), n_slots=4,
                               max_len=1024, page_size=16).fits


# ===========================================================================
# deploy_preflight against the reference
# ===========================================================================
def _deploy_pair(arch, name, dep_kw):
    cfg, jcfg = _cfgs(arch)
    s = scen.SCENARIOS[name].scaled(dep_kw.get("max_len", 64))
    js = jscen.SCENARIOS[name].scaled(dep_kw.get("max_len", 64))
    ours = deploy_preflight(cfg, s, deployment=DeploymentSpec(**dep_kw))
    ref = jdeploy.deploy_preflight(
        jcfg, js, deployment=jdeploy.DeploymentSpec(**dep_kw),
        chip=H100_AS_TPU)
    return ours, ref


DEPLOYMENTS = (dict(n_slots=4, max_len=64, page_size=8),
               dict(n_slots=3, max_len=96, page_size=0, admit_width=2,
                    dtype="float32", param_dtype="float32",
                    kv_dtypes=("float32", "int8")))


@pytest.mark.parametrize("arch", DECODERS)
@pytest.mark.parametrize("name", sorted(jscen.SCENARIOS))
@pytest.mark.parametrize("dep", range(len(DEPLOYMENTS)))
def test_deploy_preflight_matches_reference(arch, name, dep):
    ours, ref = _deploy_pair(arch, name, DEPLOYMENTS[dep])
    for key in ("rho", "rho_peak", "service_s", "tok_p50_lb_ms",
                "tok_p99_lb_ms", "ttft_lb_ms", "concurrency_demand",
                "alloc_bytes", "hbm_bytes"):
        _close(getattr(ours, key), getattr(ref, key))
    for key in ("best_batch", "cache_tokens", "compiles", "compile_bound"):
        assert getattr(ours, key) == getattr(ref, key), key
    assert [(f.rule_id, f.severity) for f in ours.findings] == \
        [(f.rule_id, f.severity) for f in ref.findings]
    assert ours.mesh == ref.mesh == {"data": 1, "model": 1}


def _cfg(arch="minicpm-2b"):
    return smoke_config(get_arch(arch))


def _scenario(rate=2.0, prompts=((16, 1.0), (32, 1.0)),
              outputs=((8, 1.0), (16, 1.0)), process="poisson",
              peak=1.0, slo=(2000.0, 50.0, 150.0)):
    return scen.Scenario(
        name="synthetic", description="test",
        arrival=scen.ArrivalSpec(rate_rps=rate, process=process,
                                 peak_factor=peak),
        prompt_lens=scen.LengthDist(tuple(prompts)),
        output_lens=scen.LengthDist(tuple(outputs)),
        slo=scen.SLOSpec(ttft_ms=slo[0], tok_p50_ms=slo[1],
                         tok_p99_ms=slo[2]))


def rule_ids(report):
    return [f.rule_id for f in report.findings]


SMALL = dict(n_slots=4, max_len=64, page_size=8)


@pytest.mark.parametrize("case", [
    "deadlock", "forced_decode", "unserveable", "exact_mode", "slo",
    "saturation", "capacity"])
def test_fixture_fires_its_rule(case):
    """The reference's fixture deployments, each firing exactly its rule
    (tests/test_analysis_deploy.py), on the port."""
    if case == "deadlock":
        rep = deploy_preflight(_cfg(), _scenario().scaled(64),
                               deployment=DeploymentSpec(**SMALL,
                                                         page_budget=3))
        want = [("deploy-admission-deadlock", "error")]
    elif case == "forced_decode":
        rep = deploy_preflight(
            _cfg("mamba2-1.3b"), _scenario(prompts=((200, 1.0), (240, 1.0)),
                                           outputs=((8, 1.0),)),
            deployment=DeploymentSpec(n_slots=4, max_len=256, page_size=0,
                                      buckets=(8,)))
        want = [("deploy-bucket-gap", "warning")]
    elif case == "unserveable":
        rep = deploy_preflight(
            _cfg(), _scenario(prompts=((60, 1.0), (64, 1.0)),
                              outputs=((8, 1.0),)),
            deployment=DeploymentSpec(**SMALL))
        want = [("deploy-bucket-gap", "warning")]
        assert "no plan" in rep.findings[0].message
    elif case == "exact_mode":
        rep = deploy_preflight(_cfg(), _scenario().scaled(64),
                               deployment=DeploymentSpec(**SMALL, buckets=()))
        want = [("deploy-bucket-gap", "info"),
                ("deploy-compile-unbounded", "warning")]
        assert rep.compile_bound == 0 and rep.ok
    elif case == "slo":
        # the card's smoke-size bounds are below the reference fixture's
        # 0.1 us: an SLO a thousand times tighter
        rep = deploy_preflight(_cfg(), _scenario(slo=(1e-6, 1e-7, 2e-7)),
                               deployment=DeploymentSpec(**SMALL))
        want = [("deploy-slo-infeasible", "error")]
    elif case == "saturation":
        dep = DeploymentSpec(**SMALL)
        probe = deploy_preflight(_cfg(), _scenario(rate=1.0).scaled(64),
                                 deployment=dep)
        rate = 0.5 / probe.rho            # -> rho ~0.5, rho_peak ~2.0
        rep = deploy_preflight(
            _cfg(), _scenario(rate=rate, process="burst",
                              peak=4.0).scaled(64), deployment=dep)
        want = [("deploy-queue-saturation", "warning")]
        assert rep.rho < 1.0 and rep.rho_peak >= dep.saturation_rho
    else:
        rep = deploy_preflight(_cfg(), _scenario().scaled(64),
                               deployment=DeploymentSpec(**SMALL,
                                                         hbm_gb=0.0001))
        want = [("deploy-capacity-overflow", "error")]
    assert [(f.rule_id, f.severity) for f in rep.findings] == want
    assert rep.ok == all(s != "error" for _, s in want)


def test_rho_bounds_and_monotonicity():
    dep = DeploymentSpec(**SMALL)
    rep = deploy_preflight(_cfg(), _scenario(rate=1e9).scaled(64),
                           deployment=dep)
    assert rep.rho >= 1.0 and "deploy-slo-infeasible" in rule_ids(rep)
    rhos = [deploy_preflight(_cfg(), _scenario(rate=r).scaled(64),
                             deployment=dep).rho
            for r in (0.5, 1.0, 2.0, 4.0)]
    assert all(b > a for a, b in zip(rhos, rhos[1:]))
    assert rhos[2] == pytest.approx(4 * rhos[0], rel=1e-6)
    good = deploy_preflight(_cfg(), "code_completion", deployment=dep)
    assert 1 <= good.best_batch <= 4 and good.tok_p50_lb_ms > 0
    assert good.tok_p99_lb_ms >= good.tok_p50_lb_ms
    assert good.rho_peak >= good.rho


def test_deployment_spec_and_defaults():
    dep = DeploymentSpec(n_slots=2, max_len=128, buckets=(8, 32),
                         kv_dtypes=("bfloat16", "int8"),
                         mesh={"data": 1, "model": 1}, hbm_gb=8.0)
    assert DeploymentSpec.from_json(dep.to_json()) == dep
    for s in scen.SCENARIOS.values():
        assert default_deployment(s).max_len >= s.max_context()
    for rid in RULE_IDS:
        assert rid in RULES
    rep = deploy_preflight(_cfg("mamba2-1.3b"), _scenario().scaled(64),
                           deployment=DeploymentSpec(**dict(SMALL,
                                                            page_budget=2)))
    assert "deploy-admission-deadlock" not in rule_ids(rep)


def test_preflight_under_100ms():
    """The launcher runs it before anything is allocated: it must stay
    cheap."""
    cfg, dep = _cfg(), DeploymentSpec(**SMALL)
    s = scen.SCENARIOS["chat_burst"].scaled(64)
    deploy_preflight(cfg, s, deployment=dep)         # warm any caches
    best = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        deploy_preflight(cfg, s, deployment=dep)
        best = min(best, time.perf_counter() - t0)
    assert best < 0.1, f"deploy_preflight took {best * 1e3:.1f} ms"


def test_clean_tree_deploy_pass_is_green():
    findings = deploy.run_pass(AnalysisContext(preset=PRESETS["ci"],
                                               root=REPO))
    assert findings == [], [f.describe() for f in findings]


# ===========================================================================
# Prefill shapes: the prediction equals the engine's counter
# ===========================================================================
@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-1.3b"])
@pytest.mark.parametrize("width", [1, 2])
def test_predict_prefill_compiles_equals_engine(arch, width):
    cfg = _cfg(arch)
    lens = (3, 5, 8, 12, 17, 30, 40, 9)
    rt = ModelRuntime(dtype="float32", attn_chunk=16, device="cpu")
    sched = Scheduler(cfg=cfg, max_len=64, admit_width=width)
    eng = ServeEngine(init_params(cfg, seed=0, device="cpu"), cfg, rt,
                      n_slots=3, max_len=64, scheduler=sched)
    rng = np.random.default_rng(5)
    for i, n in enumerate(lens):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=3))
    eng.run()
    got = eng.stats.prefill_compiles
    assert got == predict_prefill_compiles(sched, lens, (width,))
    assert got <= sched.max_prefill_compiles()


# ===========================================================================
# AST lint and the CLI
# ===========================================================================
def test_ast_lint_rules_and_waivers():
    src = ("import os\n"
           "os.environ['X'] = '1'\n"
           "k = hash('a')\n"
           "def f(a, b):\n"
           "    os.environ.setdefault('Y', '2')\n"
           "    return a.shape[0] == b.shape[0]\n"
           "h = hash('b')  # repro: ignore[ast-salted-hash] -- a "
           "process-local memo key\n"
           "g = hash('c')  # repro: ignore[ast-salted-hash]\n")
    got = sorted((f.rule_id, f.location.line) for f in lint_source(src, "x"))
    assert got == [("analysis-suppression", 8), ("ast-axis-shape-guess", 6),
                   ("ast-env-mutation", 2), ("ast-salted-hash", 3),
                   ("ast-salted-hash", 8)]


def test_ast_lint_covers_the_port_and_is_clean():
    files = target_files(REPO)
    assert "chip_smoke.py" in files
    assert os.path.join("src", "repro_torch", "launch", "serve.py") in files
    assert not any(f.startswith(os.path.join("src", "repro" + os.sep))
                   for f in files)
    rep = run_analysis("ci", rules=["ast-salted-hash", "ast-env-mutation",
                                    "ast-axis-shape-guess"], root=REPO)
    assert set(rep.passes) == {"ast_lint"}
    assert rep.findings == [], [f.describe() for f in rep.findings]


#: The port's eight passes.
PASSES = {"kernel_validator", "graph_lint", "contracts", "ast_lint",
          "liveness", "deploy_lint", "sharding_prop", "spmd_lint"}
#: The findings on a clean tree, all info: the sharding propagation's
#: cells whose specs drop an indivisible axis and the paged pools a rank
#: holds whole at paper scale (tests/test_torch_sharding_prop.py holds
#: each to the reference's), the graph lint's f32 state products of
#: the SSM decode step (tests/test_torch_graph_lint.py), and the SPMD
#: lint's note that no dry-run cells were generated
#: (tests/test_torch_spmd_lint.py).
CLEAN_INFO = {"shard-spec-dropped": 36, "shard-replicated-large": 12,
              "graph-wide-dot": 1, "spmd-lowering-skipped": 1}


def test_clean_tree_ci_preset():
    rep = run_analysis("ci", root=REPO)
    assert set(rep.passes) == PASSES
    rest = [f for f in rep.findings if f.severity != "info"]
    assert rest == [], [f.describe() for f in rest]
    assert Counter(f.rule_id for f in rep.findings) == CLEAN_INFO
    assert rep.exit_code(strict=True) == 0
    with pytest.raises(KeyError, match="unknown rule"):
        run_analysis("ci", rules=["no-such-rule"])
    with pytest.raises(KeyError, match="unknown analysis preset"):
        run_analysis("full")


def _cli(args, tmp_path, **env):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_TORCH_ARTIFACT_DIR=str(tmp_path), **env)
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def test_cli_exit_codes_and_list_rules(tmp_path):
    r = _cli(["--list-rules"], tmp_path)
    assert r.returncode == 0
    listed = [line.split()[0] for line in r.stdout.splitlines()]
    assert listed == sorted(RULES)
    r = _cli(["--preset", "ci", "--strict"], tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    payload = json.load(open(tmp_path / "analysis" / "report.json"))
    assert payload["counts"] == {"error": 0, "warning": 0,
                                 "info": sum(CLEAN_INFO.values())}
    assert set(payload["passes"]) == PASSES
    assert _cli(["--rules", "no-such-rule"], tmp_path).returncode == 2
    out = tmp_path / "elsewhere.json"
    r = _cli(["--rules", "deploy-slo-infeasible", "--output", str(out),
              "--write-baseline", str(tmp_path / "base.json")], tmp_path)
    assert r.returncode == 0 and out.exists()
    r = _cli(["--baseline", str(tmp_path / "base.json")], tmp_path)
    assert r.returncode == 0 and "0 regressed rules" in r.stdout


def test_cli_fixture_fires_exact_rule(tmp_path):
    fixture = {"cases": [{
        "arch": "minicpm-2b", "smoke": True, "scenario": "chat_burst",
        "deployment": {"n_slots": 4, "max_len": 64, "page_size": 8,
                       "page_budget": 3}}]}
    fx = tmp_path / "deploy_fixture.json"
    fx.write_text(json.dumps(fixture))
    r = _cli(["--rules", "deploy-admission-deadlock"], tmp_path,
             **{FIXTURE_ENV: str(fx)})
    assert r.returncode == 1, r.stdout + r.stderr
    payload = json.load(open(tmp_path / "analysis" / "report.json"))
    assert set(payload["passes"]) == {"deploy_lint"}
    assert [f["rule_id"] for f in payload["findings"]] == \
        ["deploy-admission-deadlock"]
    # the same fixture against an empty baseline regresses that rule
    base = tmp_path / "empty.json"
    base.write_text(json.dumps({"gate_counts": {}}))
    r = _cli(["--baseline", str(base)], tmp_path, **{FIXTURE_ENV: str(fx)})
    assert r.returncode == 1 and "deploy-admission-deadlock" in r.stderr


def test_cli_imports_neither_jax_nor_reference(tmp_path):
    prog = (
        "import runpy, sys\n"
        "sys.argv = ['repro_torch.analysis', '--preset', 'ci']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.analysis', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               REPRO_TORCH_ARTIFACT_DIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", prog], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "BAD []" in r.stdout
