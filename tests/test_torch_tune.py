"""The port's tuning path against the reference, on the CPU.

The port's LM front-end, ``cases_for_cell``, ``aggregate_policy`` and
``MeasuredModel`` are copies of the reference's and must agree with it
exactly (the measured model to 1e-12 relative). A ``ci`` mini-sweep runs
the tuner on the CPU (the plain versions run; its timings mean nothing
for the card) and checks the payload's schema, that the JAX package
loads it, the policy it implies, and the measured model priced from it.
"""
import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.configs import get_shape as jget_shape  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.core.analytical.measured import \
    MeasuredModel as JMeasured  # noqa: E402
from repro.core.analytical.measured import \
    load_calibration as jload  # noqa: E402
from repro.core.workload import lm_workload as jlm_workload  # noqa: E402
from repro.kernels import tune as jtune  # noqa: E402

from repro_torch import artifacts  # noqa: E402
from repro_torch.bench import kernel_model_error as kme  # noqa: E402
from repro_torch.configs import get_arch, get_shape, smoke_config  # noqa: E402
from repro_torch.core.analytical import (  # noqa: E402
    CALIBRATION_VERSION, ENTRY_FIELDS, CalibrationMissing, DesignPoint,
    MeasuredModel, load_calibration)
from repro_torch.core.hardware import H100_SXM  # noqa: E402
from repro_torch.core.workload import lm_workload  # noqa: E402
from repro_torch.kernels import dispatch as D  # noqa: E402
from repro_torch.kernels import tune  # noqa: E402

ARCH_IDS = ("minicpm-2b", "qwen2-moe-a2.7b", "mixtral-8x22b", "mamba2-1.3b",
            "zamba2-2.7b")
OP_FIELDS = ("name", "kind", "flops", "weight_bytes", "act_in_bytes",
             "act_out_bytes", "layer_idx", "weight_axis", "width",
             "weight_dtype", "act_dtype")
#: the mini-sweep's cells: together they reach every op
SWEEP_CELLS = (("minicpm-2b", "decode_32k"), ("qwen2-moe-a2.7b",
                                              "prefill_32k"),
               ("mamba2-1.3b", "prefill_32k"))


def _cfgs(arch, smoke):
    jc, tc = jget_arch(arch), get_arch(arch)
    return (jsmoke(jc), smoke_config(tc)) if smoke else (jc, tc)


# ===========================================================================
# LM front-end
# ===========================================================================
@pytest.mark.parametrize("dtypes", [(None, None), ("int8", "int8"),
                                    ("int8", None), (None, "int8")])
@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_lm_workload_matches_reference(arch, smoke, dtypes):
    jc, tc = _cfgs(arch, smoke)
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        want = jlm_workload(jc, jget_shape(shape), weight_dtype=dtypes[0],
                            kv_dtype=dtypes[1])
        got = lm_workload(tc, get_shape(shape), weight_dtype=dtypes[0],
                          kv_dtype=dtypes[1])
        assert [tuple(getattr(o, f) for f in OP_FIELDS) for o in got.ops] \
            == [tuple(getattr(o, f) for f in OP_FIELDS) for o in want.ops]
        assert [o.total_bytes for o in got] == [o.total_bytes for o in want]
        assert (got.name, got.kind, got.meta) == (want.name, want.kind,
                                                  want.meta)
        assert got.model_flops() == want.model_flops()


def test_lm_workload_resolves_ids_and_decode_kv_len():
    want = jlm_workload("minicpm-2b", "decode_32k", kv_len=1000)
    got = lm_workload("minicpm-2b", "decode_32k", kv_len=1000)
    assert [o.act_in_bytes for o in got] == [o.act_in_bytes for o in want]
    assert got.meta["kv_len"] == 1000
    # every reference arch resolves, the last-ported ones included
    want = jlm_workload("qwen2-vl-7b", "decode_32k")
    got = lm_workload("qwen2-vl-7b", "decode_32k")
    assert [o.act_in_bytes for o in got] == [o.act_in_bytes for o in want]
    with pytest.raises(KeyError):
        lm_workload("gpt-2", "decode_32k")


# ===========================================================================
# cases_for_cell
# ===========================================================================
def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _assert_cases_equal(got, want, arg_shapes):
    assert [c.op for c in got] == [c.op for c in want]
    for g, w, (gs, ws) in zip(got, want, arg_shapes):
        assert (g.arch, g.shape, g.kind, g.source_op) == \
            (w.arch, w.shape, w.kind, w.source_op)
        assert g.case == w.case, g.op
        assert g.kwargs == w.kwargs, g.op
        assert (g.flops, g.bytes) == (w.flops, w.bytes), g.op
        assert gs == ws, g.op


@pytest.mark.parametrize("arch,shape", tune.CI.cells)
def test_ci_cases_match_reference(arch, shape):
    got = tune.cases_for_cell(tune.CI.arch(arch), tune.CI.shape(shape),
                              page_sizes=tune.CI.paged_page_sizes)
    jp = jtune.CI
    want = jtune.cases_for_cell(jp.arch(arch), jp.shape(shape),
                                page_sizes=jp.paged_page_sizes)
    shapes = [([(tuple(a.shape), _dtype_name(a)) for a in g.make_args()],
               [(tuple(a.shape), str(a.dtype)) for a in w.make_args()])
              for g, w in zip(got, want)]
    _assert_cases_equal(got, want, shapes)


@pytest.mark.parametrize("arch,shape", tune.H100.cells)
def test_h100_cases_match_reference_at_the_ports_bench_batch(arch, shape):
    """Full width: inputs on the meta device (shapes without memory)
    against the reference's abstract evaluation."""
    p = tune.H100
    got = tune.cases_for_cell(p.arch(arch), p.shape(shape),
                              bench_batch=p.bench_batch,
                              page_sizes=p.paged_page_sizes, device="meta")
    want = jtune.cases_for_cell(jget_arch(arch), jget_shape(shape),
                                bench_batch=p.bench_batch,
                                page_sizes=p.paged_page_sizes)
    shapes = [([(tuple(a.shape), _dtype_name(a)) for a in g.make_args()],
               [(tuple(a.shape), str(a.dtype))
                for a in jax.eval_shape(w.make_args)])
              for g, w in zip(got, want)]
    _assert_cases_equal(got, want, shapes)
    assert all(a.device.type == "meta" for c in got for a in c.make_args())


def test_h100_quant_matmul_cases():
    """The int8-weight matmul shapes the card times: N recovered from the
    int8 weight bytes (minicpm-2b and stablelm-12b: 3 d_ff; qwen2-moe:
    the merged shared experts; mixtral, with no dense FFN: the QKV
    projection)."""
    p = tune.H100
    got = {}
    for arch, shape in p.cells:
        for c in tune.cases_for_cell(p.arch(arch), p.shape(shape),
                                     bench_batch=1, device="meta"):
            if c.op == "quant_matmul":
                got[(arch, shape)] = (c.case["T"], c.case["K"], c.case["N"])
    assert got == {
        ("minicpm-2b", "prefill_32k"): (32768, 2304, 17280),
        ("minicpm-2b", "decode_32k"): (1, 2304, 17280),
        ("stablelm-12b", "prefill_32k"): (32768, 5120, 41472),
        ("qwen2-moe-a2.7b", "prefill_32k"): (32768, 2048, 16896),
        ("mixtral-8x22b", "decode_32k"): (1, 6144, 8192),
    }


def test_grids_carry_an_explicit_row_per_impl_and_the_sweep_is_unchanged():
    """Every registered (op, impl) has its own grid row (the contract
    checker reads ``preset.grids`` literally), a fixed-tile kernel's row
    being one point with no parameter: so the sweep times the same
    params it timed when those rows were left to ``grid``'s default."""
    for p in (tune.CI, tune.H100):
        for op in D.KERNEL_OPS:
            assert set(p.grids[op]) == set(D.implementations(op)), op
            for impl in p.grids[op]:
                assert p.grid(op, impl) == tuple(p.grids[op][impl])
                assert len(p.grid(op, impl)) >= 1
            if op not in ("prefill_attention", "ssd_scan"):
                assert p.grids[op] == {"torch": ({},), "cuda": ({},)}, op
    assert tune.CI.grids["prefill_attention"] == {
        "torch": ({"chunk": 64}, {"chunk": 128}), "cuda": ({},)}
    assert tune.H100.grids["ssd_scan"] == {
        "torch": ({"chunk": 128}, {"chunk": 256}),
        "cuda": ({"chunk": 128}, {"chunk": 256})}


def test_h100_grids_name_only_what_the_kernels_honour():
    """A cuda grid lists only parameters its kernel reads (the SSD scan's
    chunk); a torch grid carries the reference's xla grid."""
    for p, jp in ((tune.H100, jtune.FULL), (tune.CI, jtune.CI)):
        for op in D.KERNEL_OPS:
            assert p.grid(op, "torch") == jp.grid(op, "xla"), op
            want = jp.grid(op, "pallas") if op == "ssd_scan" else ({},)
            assert p.grid(op, "cuda") == want, op


# ===========================================================================
# The ci mini-sweep on the CPU
# ===========================================================================
@pytest.fixture(scope="module")
def sweep():
    return tune.run_tuning(tune.CI, cells=SWEEP_CELLS, reps=1, device="cpu",
                           log=lambda _: None)


def test_sweep_schema(sweep):
    assert sweep["version"] == CALIBRATION_VERSION == 2
    assert (sweep["preset"], sweep["backend"], sweep["interpret"]) == \
        ("ci", "cpu", True)
    assert sweep["timer"].startswith("perf_counter")
    assert "device" not in sweep and sweep["validation"] is None
    assert set(sweep) >= {"version", "preset", "backend", "interpret",
                          "generated_unix", "cells", "entries", "policy",
                          "validation"}
    assert sweep["cells"] == [list(c) for c in SWEEP_CELLS]
    assert {e["op"] for e in sweep["entries"]} == set(D.KERNEL_OPS)
    for e in sweep["entries"]:
        assert all(k in e for k in ENTRY_FIELDS)
        assert set(e["impls"]) == {"torch", "cuda"}
        for impl, rec in e["impls"].items():
            grid = tune.CI.grid(e["op"], impl)
            assert [t["params"] for t in rec["timings"]] == list(grid)
            assert all(len(t["times"]) == 1 and t["best_s"] > 0
                       for t in rec["timings"])
        assert e["best_s"] == e["impls"][e["winner"]]["best_s"]
    json.dumps(sweep)


def test_sweep_loads_in_both_packages(sweep, tmp_path):
    path = tune.write_calibration(sweep, str(tmp_path / "calib.json"))
    assert jload(path)["entries"] == load_calibration(path)["entries"]


def test_aggregate_policy_matches_reference(sweep):
    assert tune.aggregate_policy(sweep["entries"]) == \
        jtune.aggregate_policy(sweep["entries"]) == sweep["policy"]


def test_from_calibration_reproduces_the_policy(sweep):
    pol = D.KernelPolicy.from_calibration(sweep)
    for op in D.KERNEL_OPS:
        choice = sweep["policy"][op]
        assert pol.impl_for(op) == choice["impl"]
        assert pol.params_for(op) == choice["params"]
        # fixed call-site kwargs never leak into a calibrated policy
        assert not set(pol.params_for(op)) & {"causal", "window",
                                              "n_experts"}
    assert set(pol.params_for("prefill_attention")) <= {"chunk"}
    # an op the calibration does not name keeps the port's default
    partial = dict(sweep, policy={"rmsnorm": {"impl": "torch",
                                              "params": {}}})
    pol = D.KernelPolicy.from_calibration(partial)
    assert pol.impl_for("rmsnorm") == "torch"
    assert pol.impl_for("quant_matmul") == "cuda" and pol.params == ()


def test_calibrated_policy_dispatches_with_its_params(sweep, monkeypatch):
    """The calibrated impl of ssd_scan runs with the calibrated chunk, not
    the call site's."""
    pol = D.KernelPolicy.from_calibration(sweep)
    impl = pol.impl_for("ssd_scan")
    seen = []
    real = D.implementations("ssd_scan")[impl]
    monkeypatch.setitem(D.implementations("ssd_scan"), impl,
                        lambda *a, **kw: seen.append(kw) or real(*a, **kw))
    case = [c for c in tune.cases_for_cell(tune.CI.arch("mamba2-1.3b"),
                                           tune.CI.shape("prefill_32k"))
            if c.op == "ssd_scan"][0]
    D.dispatch("ssd_scan", pol, *case.make_args(), chunk=7)
    assert seen == [{"chunk": sweep["policy"]["ssd_scan"]["params"]
                     ["chunk"]}]


@pytest.mark.parametrize("arch,shape", SWEEP_CELLS)
def test_measured_model_matches_reference(sweep, arch, shape):
    wl = lm_workload(tune.CI.arch(arch), tune.CI.shape(shape))
    jwl = jlm_workload(jtune.CI.arch(arch), jtune.CI.shape(shape))
    got = MeasuredModel(wl, sweep, chip=H100_SXM).evaluate(DesignPoint.make())
    want = JMeasured(jwl, sweep).evaluate(None)
    assert got.feasible and want.feasible
    for a, b in ((got.latency_s, want.latency_s), (got.gops, want.gops),
                 (got.throughput, want.throughput)):
        assert math.isclose(a, b, rel_tol=1e-12)
    assert [(r["name"], r["source"]) for r in got.detail] == \
        [(r["name"], r["source"]) for r in want.detail]
    for r, s in zip(got.detail, want.detail):
        assert math.isclose(r["latency_s"], s["latency_s"], rel_tol=1e-12)
    assert got.resources == want.resources
    assert math.isclose(got.efficiency,
                        wl.model_flops() / got.latency_s / 989e12,
                        rel_tol=1e-12)


def test_measured_model_defaults_to_the_h100(sweep):
    wl = lm_workload(tune.CI.arch("minicpm-2b"), tune.CI.shape("decode_32k"))
    m = MeasuredModel(wl, sweep)
    assert m.chip is H100_SXM
    assert H100_SXM.peak_flops() == 989e12
    assert H100_SXM.peak_flops("int8") == 1979e12
    assert H100_SXM.peak_flops("float32") == 67e12
    assert (H100_SXM.hbm_bw, H100_SXM.hbm_bytes, H100_SXM.sms,
            H100_SXM.smem_per_block) == (3.35e12, 80e9, 132, 232_448)


def test_calibration_missing_is_loud(sweep, tmp_path, monkeypatch):
    monkeypatch.setenv(artifacts.ENV_VAR, str(tmp_path / "root"))
    with pytest.raises(CalibrationMissing, match="repro_torch.kernels.tune"):
        load_calibration()
    with pytest.raises(CalibrationMissing):
        MeasuredModel(lm_workload(get_arch("minicpm-2b"),
                                  get_shape("decode_32k")))
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps(dict(sweep, version=1)))
    with pytest.raises(CalibrationMissing, match="version 1"):
        load_calibration(str(stale))
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps(dict(sweep, entries=[])))
    with pytest.raises(CalibrationMissing, match="no entries"):
        load_calibration(str(empty))
    drift = tmp_path / "drift.json"
    drift.write_text(json.dumps(dict(
        sweep, entries=[{k: v for k, v in sweep["entries"][0].items()
                         if k != "bytes"}])))
    with pytest.raises(CalibrationMissing, match="bytes"):
        load_calibration(str(drift))


def test_kernel_model_error_rows(sweep, tmp_path, monkeypatch):
    monkeypatch.setenv(artifacts.ENV_VAR, str(tmp_path))
    out = kme.run(sweep)
    assert out["pass"] and out["ops"] == len(sweep["entries"])
    assert out["workloads"] == len(SWEEP_CELLS)
    errs = [r["err_pct"] for r in out["op_rows"]]
    assert out["median_err_pct"] == float(np.median(errs))
    # the envelope's own best entries sit on the roofline
    assert min(errs) == 0.0
    for name in ("kernel_model_error", "kernel_measured_workloads",
                 "kernel_model_error_summary"):
        assert (tmp_path / "bench" / f"{name}.json").is_file()


# ===========================================================================
# Artifact path and CLI
# ===========================================================================
def test_calibration_lands_under_the_ports_root(monkeypatch, tmp_path):
    monkeypatch.delenv(artifacts.ENV_VAR, raising=False)
    monkeypatch.chdir(tmp_path)
    path = artifacts.calibration_path()
    assert path == os.path.join(str(tmp_path), "artifacts", "torch",
                                "kernels", "calibration.json")
    from repro.artifacts import calibration_path as jpath
    monkeypatch.delenv("REPRO_ARTIFACT_DIR", raising=False)
    assert path != jpath()
    monkeypatch.setenv(artifacts.ENV_VAR, str(tmp_path / "elsewhere"))
    assert artifacts.calibration_path().startswith(str(tmp_path /
                                                       "elsewhere"))


def test_cli_ci_on_the_cpu_writes_the_ports_file(monkeypatch, tmp_path,
                                                 capsys):
    monkeypatch.setenv(artifacts.ENV_VAR, str(tmp_path))
    rc = tune.main(["--preset", "ci", "--device", "cpu", "--reps", "1",
                    "--cells", "minicpm-2b/decode_32k"])
    assert rc == 0
    out = capsys.readouterr().out
    assert ("static kernel validator: {'findings': 0, 'errors': 0, "
            "'rules': []}") in out
    payload = load_calibration(str(tmp_path / "kernels" /
                                   "calibration.json"))
    assert payload["cells"] == [["minicpm-2b", "decode_32k"]]


@pytest.mark.parametrize("argv,msg", [
    (["--preset", "ci", "--cells", "minicpm-2b"], "arch/shape"),
    (["--preset", "ci", "--cells", "gpt-2/decode_32k"], "gpt-2"),
    (["--preset", "ci", "--cells", "minicpm-2b/train_4k"], "unknown shape"),
])
def test_cli_rejects_bad_cells(argv, msg, capsys):
    assert tune.main(argv + ["--device", "cpu"]) == 2
    assert msg in capsys.readouterr().err


def test_tuner_refuses_without_a_card_and_has_no_validator(monkeypatch,
                                                           capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tune.main(["--preset", "ci"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.run_tuning(tune.CI, device="cuda")
    # validate=True is taken (the validator runs on meta); timing still
    # needs the card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.run_tuning(tune.CI, validate=True, device="cuda")
    assert not hasattr(tune, "VALIDATOR_PENDING")


def test_quant_matmul_bench_refuses_without_a_card(monkeypatch, capsys):
    from repro_torch.bench import quant_matmul as qbench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert qbench.main(["--iters", "1"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_time_impl_records_only_the_tuning_params():
    calls = []

    def fn(x, **kw):
        calls.append(kw)
        return x

    rec = tune.time_impl(fn, (torch.zeros(2),), {"chunk": 4}, reps=3,
                         warmup=2, fixed_kwargs={"causal": True})
    assert rec["params"] == {"chunk": 4} and len(rec["times"]) == 3
    assert rec["best_s"] == min(rec["times"])
    assert calls == [{"causal": True, "chunk": 4}] * 5
    preset = dataclasses.replace(tune.CI, reps=1)
    assert preset.grid("rmsnorm", "cuda") == ({},)
