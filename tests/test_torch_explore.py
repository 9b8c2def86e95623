"""The paper's system in the port, held equal to the reference on the CPU.

The FPGA spec, the Workload IR's conv geometry, the CNN front-end and
registry, the paradigm 1-3 models, the design space, Pareto front, PSO
and search core, ``explore_fpga``/``benchmark_paradigm`` and the event
simulator are copies of the reference's. Every model and design point of
the reference's own tests (``test_dse.py``, ``test_analytical.py``,
``test_sim_vs_model.py``, ``test_workload_ir.py``) goes through both
packages, and every number must agree to 1e-12 relative; seeded searches
must return the same best point and the same Pareto front.
"""
import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import hardware as jhw
from repro.core.analytical import generic as jgeneric
from repro.core.analytical import hybrid as jhybrid
from repro.core.analytical import interface as jiface
from repro.core.analytical import pipeline as jpipeline
from repro.core.dse import engine as jengine
from repro.core.dse import search as jsearch
from repro.core.dse import space as jspace
from repro.core.dse.pso import particle_swarm as jpso
from repro.core import workload as jwl
from repro.sim import simulator as jsim

from repro_torch.core import hardware as hw
from repro_torch.core.analytical import generic
from repro_torch.core.analytical import hybrid
from repro_torch.core.analytical import interface as iface
from repro_torch.core.analytical import pipeline
from repro_torch.core.dse import engine
from repro_torch.core.dse import search
from repro_torch.core.dse import space
from repro_torch.core.dse.pso import particle_swarm
from repro_torch.core import workload as wl
from repro_torch.sim import simulator as sim

REL = 1e-12
BOARDS = ("KU115", "ZC706", "VU9P", "ZCU102")
NETS = ("vgg16", "alexnet", "zf", "yolo", "resnet18", "resnet34")
RESULT_FIELDS = ("gops", "throughput", "latency_s", "efficiency",
                 "feasible", "reason")


def _close(a, b):
    if isinstance(a, float) or isinstance(b, float):
        return math.isclose(a, b, rel_tol=REL, abs_tol=0.0) \
            or (math.isnan(a) and math.isnan(b))
    return a == b


def _same(a, b, path="$"):
    """Recursive equality across the two packages' records: dataclasses
    by field, floats to 1e-12 relative, the rest exactly."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert dataclasses.is_dataclass(b), path
        assert type(a).__name__ == type(b).__name__, path
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], path
        for f in fa:
            _same(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_allclose(a, b, rtol=REL, atol=0.0, err_msg=path)
    else:
        assert _close(a, b), f"{path}: {a!r} != {b!r}"


def _same_result(got, want):
    for f in RESULT_FIELDS:
        assert _close(getattr(got, f), getattr(want, f)), f
    _same(got.resources, want.resources, "resources")
    if want.detail is not None and hasattr(want.detail, "gops"):
        _same(got.detail, want.detail, "detail")
        assert _close(got.detail.gops(), want.detail.gops())


def _layers(pkg, net, size=None, extra=0):
    """The zoo's ConvLayer chain of ``net`` from one package."""
    w = pkg.cnn_workload(net, input_size=size, extra_per_group=extra)
    return w.conv_layers()


# ===========================================================================
# Hardware and the CNN front-end
# ===========================================================================
def test_fpga_specs_match_reference():
    assert sorted(hw.FPGAS) == sorted(jhw.FPGAS)
    for name in BOARDS:
        _same(hw.FPGAS[name], jhw.FPGAS[name])
        for bits in (4, 8, 16):
            assert hw.FPGAS[name].peak_gops(bits) \
                == jhw.FPGAS[name].peak_gops(bits)
        assert hw.FPGAS[name].bram_bytes == jhw.FPGAS[name].bram_bytes


@pytest.mark.parametrize("size", [None, 32, 128, 512])
@pytest.mark.parametrize("net", NETS)
def test_cnn_zoo_matches_reference(net, size):
    got, want = wl.cnn_workload(net, size), jwl.cnn_workload(net, size)
    _same(got.ops, want.ops)
    _same(got.meta, want.meta)
    assert (got.name, got.kind, got.frontend) == (want.name, want.kind,
                                                  want.frontend)
    assert got.total_ops() == want.total_ops()
    assert got.total_weight_bytes() == want.total_weight_bytes()
    assert got.total_act_bytes() == want.total_act_bytes()
    assert got.flops_by_kind() == want.flops_by_kind()
    assert got.weight_flops() == want.weight_flops()
    assert got.intensity() == want.intensity()
    assert got.summary() == want.summary()
    assert got.describe() == want.describe()
    for mode in ("external", "total"):
        for bits in ((16, 16), (8, 8), (16, 8)):
            assert got.ctc_stats(*bits, mode) == want.ctc_stats(*bits, mode)
            assert wl.Workload.coerce(got.conv_layers()).ctc_stats(
                *bits, mode) == want.ctc_stats(*bits, mode)


@pytest.mark.parametrize("extra", [1, 2, 5])
def test_cnn_vgg_depth_variants_match_reference(extra):
    got = wl.cnn_workload("vgg16", input_size=224, extra_per_group=extra)
    want = jwl.cnn_workload("vgg16", input_size=224, extra_per_group=extra)
    _same(got.ops, want.ops)
    assert got.ctc_stats() == want.ctc_stats()


@pytest.mark.parametrize("fmap,cin,k,stride",
                         [(56, 64, 3, 1), (224, 512, 1, 1), (28, 256, 5, 2),
                          (7, 2048, 3, 1)])
def test_conv_case_matches_reference(fmap, cin, k, stride):
    got = wl.conv_case_workload(fmap, cin, k=k, stride=stride)
    want = jwl.conv_case_workload(fmap, cin, k=k, stride=stride)
    _same(got.ops, want.ops)
    assert got.ctc_stats("total") == want.ctc_stats("total")


def test_coerce_paths_match_reference():
    layers = _layers(wl, "alexnet")
    got = wl.Workload.coerce(layers, name="x")
    want = jwl.Workload.coerce(_layers(jwl, "alexnet"), name="x")
    _same(got.ops, want.ops)
    assert got.frontend == want.frontend == "cnn"
    assert wl.as_conv_layers(got) == layers
    with pytest.raises(wl.WorkloadError):
        wl.lm_workload("minicpm-2b", "train_4k").conv_layers()
    with pytest.raises(wl.EmptyWorkloadError):
        wl.Workload.coerce([], name="empty").ctc_stats()


def test_lm_ops_keep_their_positional_fields():
    """``spatial`` sits between ``width`` and ``weight_dtype`` as in the
    reference, so a positional ``OpInfo(...)`` means the same in both."""
    names = [f.name for f in dataclasses.fields(wl.Op)]
    assert names == [f.name for f in dataclasses.fields(jwl.Op)]
    assert names.index("spatial") == names.index("width") + 1
    args = ("o", 1.0, 2.0, 3.0, 4.0, "matmul", 0, "ffn", 128)
    _same(wl.OpInfo(*args), jwl.OpInfo(*args))


# ===========================================================================
# The registry and the CLI
# ===========================================================================
def test_registry_cnn_entries_match_reference():
    def cnn_rows(rows):
        return [r for r in rows if r["frontend"] == "cnn"]
    assert cnn_rows(wl.list_workloads()) == cnn_rows(jwl.list_workloads())
    def names(rows, frontend):
        return [r["name"] for r in rows if r["frontend"] == frontend]
    # every arch of the reference: the same lm and trace rows, name for
    # name
    assert names(wl.list_workloads(), "lm") == \
        names(jwl.list_workloads(), "lm")
    assert names(wl.list_workloads(), "torch_trace") == \
        names(jwl.list_workloads(), "jax_trace")
    assert len(names(wl.list_workloads(), "lm")) == 10 * 4
    for name in NETS:
        _same(wl.get_workload(name).ops, jwl.get_workload(name).ops)
    _same(wl.get_workload("conv_case", fmap=56, cin=64, k=3).ops,
          jwl.get_workload("conv_case", fmap=56, cin=64, k=3).ops)
    _same(wl.get_workload("vgg16", input_size=384).ops,
          jwl.get_workload("vgg16", input_size=384).ops)


def test_registry_resolution_and_refusals():
    got = wl.get_workload("minicpm_2b/train_4k")
    want = jwl.get_workload("minicpm_2b/train_4k")
    _same(got.ops, want.ops)
    for bad in ("nope", "nope/train_4k", "minicpm-2b/nope"):
        with pytest.raises(wl.WorkloadError):
            wl.get_workload(bad)
    traced = wl.get_workload("trace:minicpm_2b/train_4k")
    assert traced.name == "trace:minicpm-2b/train_4k"
    assert traced.frontend == "torch_trace"
    assert traced.weight_flops() == pytest.approx(got.weight_flops(),
                                                  rel=1e-9)
    decode = wl.get_workload("trace:minicpm-2b/decode_32k", kv_len=4096)
    assert decode.meta["kv_len"] == 4096 and decode.kind == "decode"
    for bad in ("trace:minicpm-2b", "trace:nope/train_4k"):
        with pytest.raises(wl.WorkloadError):
            wl.get_workload(bad)


def _cli(*args):
    src = str(Path(__file__).resolve().parents[1] / "src")
    return subprocess.run([sys.executable, "-m", "repro_torch.workloads",
                           *args], capture_output=True, text=True,
                          env={"PYTHONPATH": src, "PATH": "/usr/bin:/bin"},
                          timeout=120)


@pytest.mark.parametrize("args", [("list",), ("list", "--frontend", "cnn"),
                                  ("list", "--frontend", "torch_trace"),
                                  ("show", "vgg16"),
                                  ("show", "resnet18", "--input-size", "384"),
                                  ("show", "minicpm-2b/decode_32k",
                                   "--kv-len", "4096", "--limit", "0"),
                                  ("show", "trace:mamba2-1.3b/decode_32k",
                                   "--kv-len", "4096")])
def test_cli_list_and_show(args):
    out = _cli(*args)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip()


def test_cli_refuses_diff_and_bad_flags():
    """``diff`` exits 1 where the weight-matmul FLOPs disagree beyond
    ``--tol``: qwen2-moe's capacity path computes ``capacity_factor``
    times the routed rows the analytic profile counts (1.25 at 60
    experts, top-4: ratio 1.087 over the whole model)."""
    out = _cli("diff", "--model", "qwen2-moe-a2.7b", "--shape",
               "prefill_32k")
    assert out.returncode == 1 and "DISAGREE" in out.stdout, out.stderr
    out = _cli("show", "vgg16", "--kv-len", "8")
    assert out.returncode == 2
    out = _cli("show", "trace:minicpm-2b/train_4k", "--input-size", "8")
    assert out.returncode == 2


def test_cli_diff_agrees_on_minicpm():
    out = _cli("diff", "--model", "minicpm-2b", "--shape", "train_4k",
               "--tol", "0.05")
    assert out.returncode == 0, out.stderr
    assert "weight-matmul FLOPs agree: traced/analytic = 1.0000" \
        in out.stdout
    assert "matmul.2304x122753" in out.stdout      # the lm_head row


# ===========================================================================
# Paradigm 1: Algorithms 1 and 2
# ===========================================================================
@pytest.mark.parametrize("pf", [64, 512, 2048, 4096, 11040, 16384])
def test_alg1_matches_reference(pf):
    for net in ("vgg16", "alexnet"):
        got = pipeline.allocate_compute(_layers(wl, net), pf)
        want = jpipeline.allocate_compute(_layers(jwl, net), pf)
        _same(got, want)
    trunk, jtrunk = _layers(wl, "alexnet")[:5], _layers(jwl, "alexnet")[:5]
    for budget in (pf, 2 * pf):
        _same(pipeline.pipeline_performance(trunk, hw.KU115,
                                            dsp_budget=budget),
              jpipeline.pipeline_performance(jtrunk, jhw.KU115,
                                             dsp_budget=budget))


def test_alg2_matches_reference():
    for net in NETS:
        for b in BOARDS:
            got = pipeline.pipeline_performance(_layers(wl, net),
                                                hw.FPGAS[b])
            want = jpipeline.pipeline_performance(_layers(jwl, net),
                                                  jhw.FPGAS[b])
            _same(got, want)
            assert _close(got.gops(), want.gops())
            assert _close(pipeline.pipeline_dsp_efficiency(got, hw.FPGAS[b]),
                          jpipeline.pipeline_dsp_efficiency(want,
                                                            jhw.FPGAS[b]))
    layer = wl.ConvLayer("c", 56, 56, 256, 256, 3, 3)
    jlayer = jwl.ConvLayer("c", 56, 56, 256, 256, 3, 3)
    for col in (1, 4):
        s = pipeline.StageConfig(layer, cpf=64, kpf=8, col=col)
        js = jpipeline.StageConfig(jlayer, cpf=64, kpf=8, col=col)
        assert s.weight_stream_bytes_per_image(16) \
            == js.weight_stream_bytes_per_image(16)


# ===========================================================================
# Paradigm 2: Algorithm 3, Eqs. 3-10
# ===========================================================================
@pytest.mark.parametrize("fm", [28, 56, 112, 224])
@pytest.mark.parametrize("cin", [64, 128, 256, 512])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_generic_dse_single_layer_matches_reference(fm, cin, k):
    got = generic.generic_dse([wl.ConvLayer("x", fm, fm, cin, cin, k, k)],
                              hw.VU9P)
    want = jgeneric.generic_dse([jwl.ConvLayer("x", fm, fm, cin, cin, k, k)],
                                jhw.VU9P)
    _same(got, want)
    assert _close(got.gops(), want.gops())


def test_generic_latency_formulas_match_reference():
    hwp = generic.GenericHWParams(64, 64, 1e6, 1e6, 1e6, 1e9, 1e9, 1e9)
    jhwp = jgeneric.GenericHWParams(64, 64, 1e6, 1e6, 1e6, 1e9, 1e9, 1e9)
    for layer, batch in ((("fc", 1, 1, 4096, 4096, 1, 1), 8),
                         (("c", 112, 112, 64, 64, 3, 3), 1)):
        pad = {"pad": 0} if layer[0] == "fc" else {}
        got = generic.generic_layer_latency(wl.ConvLayer(*layer, **pad), hwp,
                                            2e8, 16, 16, batch=batch)
        want = jgeneric.generic_layer_latency(jwl.ConvLayer(*layer, **pad),
                                              jhwp, 2e8, 16, 16, batch=batch)
        _same(got, want)
    for net in NETS:
        got = generic.generic_dse(_layers(wl, net), hw.VU9P)
        want = jgeneric.generic_dse(_layers(jwl, net), jhw.VU9P)
        _same(got, want)
        assert generic.generic_dsp_used(got, hw.VU9P) \
            == jgeneric.generic_dsp_used(want, jhw.VU9P)


# ===========================================================================
# Paradigm 3 and the shared AcceleratorModel interface
# ===========================================================================
def test_hybrid_performance_matches_reference():
    layers, jlayers = _layers(wl, "vgg16"), _layers(jwl, "vgg16")
    for sp in (0, 4, 6, len(layers)):
        got = hybrid.hybrid_performance(layers, hw.KU115, sp)
        want = jhybrid.hybrid_performance(jlayers, jhw.KU115, sp)
        _same(got, want)
        assert _close(got.gops(), want.gops())
        assert _close(got.dsp_used(), want.dsp_used())
        assert _close(got.dsp_efficiency(), want.dsp_efficiency())


def _points(n, spec):
    """The design points the reference's tests evaluate, at every board:
    paradigms 1/2 at batch 1 and 4, the hybrid at the test's split."""
    return [
        ("pipeline", dict(batch=1)), ("pipeline", dict(batch=4)),
        ("generic", dict(batch=1)), ("generic", dict(batch=4)),
        ("hybrid", dict(sp=3, batch=1, dsp_p=spec.dsp // 2,
                        bram_p=spec.bram_bytes / 2,
                        bw_p=spec.bw_bytes / 2)),
        ("hybrid", dict(sp=n // 2, batch=2, dsp_p=spec.dsp // 3,
                        bram_p=spec.bram_bytes / 4,
                        bw_p=spec.bw_bytes / 3)),
        ("hybrid", dict(sp=0, batch=1, dsp_p=0, bram_p=0.0,
                        bw_p=0.05 * spec.bw_bytes)),
        ("hybrid", dict(sp=n, batch=1, dsp_p=spec.dsp,
                        bram_p=0.7 * spec.bram_bytes,
                        bw_p=0.9 * spec.bw_bytes)),
    ]


_MODELS = {"pipeline": "PipelineModel", "generic": "GenericModel",
           "hybrid": "HybridModel"}
_MODS = {"pipeline": (pipeline, jpipeline), "generic": (generic, jgeneric),
         "hybrid": (hybrid, jhybrid)}


@pytest.mark.parametrize("board", BOARDS)
@pytest.mark.parametrize("net", NETS)
def test_models_evaluate_like_reference(net, board):
    w, jw = wl.cnn_workload(net), jwl.cnn_workload(net)
    spec, jspec = hw.FPGAS[board], jhw.FPGAS[board]
    for kind, knobs in _points(len(w.ops), spec):
        mod, jmod = _MODS[kind]
        model = getattr(mod, _MODELS[kind])(w, spec)
        jmodel = getattr(jmod, _MODELS[kind])(jw, jspec)
        assert model.name == jmodel.name
        assert isinstance(model, iface.AcceleratorModel)
        got = model.evaluate(iface.DesignPoint.make(**knobs))
        want = jmodel.evaluate(jiface.DesignPoint.make(**knobs))
        _same_result(got, want)


# ===========================================================================
# The simulator
# ===========================================================================
PIPE_CASES = [("vgg16", 224, "KU115", 1), ("alexnet", 224, "KU115", 1),
              ("alexnet", 224, "KU115", 8), ("zf", 224, "ZC706", 1),
              ("yolo", 448, "ZC706", 1), ("resnet18", 224, "KU115", 4)]


@pytest.mark.parametrize("net,size,board,batch", PIPE_CASES)
def test_simulate_pipeline_matches_reference(net, size, board, batch):
    d = pipeline.pipeline_performance(_layers(wl, net, size),
                                      hw.FPGAS[board], batch=batch)
    jd = jpipeline.pipeline_performance(_layers(jwl, net, size),
                                        jhw.FPGAS[board], batch=batch)
    _same(d, jd)
    _same(sim.simulate_pipeline(d, hw.FPGAS[board]),
          jsim.simulate_pipeline(jd, jhw.FPGAS[board]))
    _same(sim.simulate(d, hw.FPGAS[board]),
          jsim.simulate(jd, jhw.FPGAS[board]))


@pytest.mark.parametrize("fm", [56, 224])
@pytest.mark.parametrize("ch", [64, 512])
@pytest.mark.parametrize("k", [1, 3])
def test_simulate_generic_matches_reference(fm, ch, k):
    d = generic.generic_dse([wl.ConvLayer("c", fm, fm, ch, ch, k, k)],
                            hw.VU9P)
    jd = jgeneric.generic_dse([jwl.ConvLayer("c", fm, fm, ch, ch, k, k)],
                              jhw.VU9P)
    _same(sim.simulate_generic(d, hw.VU9P),
          jsim.simulate_generic(jd, jhw.VU9P))


@pytest.mark.parametrize("paradigm", [1, 2])
@pytest.mark.parametrize("net", NETS)
def test_simulate_workload_matches_reference(net, paradigm):
    for board, batch in (("KU115", 1), ("ZC706", 2)):
        _same(sim.simulate_workload(wl.cnn_workload(net), hw.FPGAS[board],
                                    paradigm, batch),
              jsim.simulate_workload(jwl.cnn_workload(net),
                                     jhw.FPGAS[board], paradigm, batch))
    with pytest.raises(ValueError):
        sim.simulate_workload(wl.cnn_workload(net), hw.KU115, 3)


# ===========================================================================
# The DSE: space, PSO, search strategies, explore_fpga, benchmark_paradigm
# ===========================================================================
def _same_search(got, want):
    """Same best point and fitness, same trajectory and the same front."""
    assert got.best_point.knobs == want.best_point.knobs
    assert _close(got.best_fitness, want.best_fitness)
    _same_result(got.best_result, want.best_result)
    _same(got.history, want.history)
    _same(got.position_history, want.position_history)
    assert (got.strategy, got.calls, got.unique_evaluations,
            got.cache_hits) == (want.strategy, want.calls,
                                want.unique_evaluations, want.cache_hits)
    assert len(got.pareto) == len(want.pareto) >= 1
    for e, je in zip(got.pareto, want.pareto):
        assert e.point.knobs == je.point.knobs
        _same(e.canonical, je.canonical)
        _same_result(e.result, je.result)
    assert got.pareto.table() == want.pareto.table()


def test_space_snap_and_keys_match_reference():
    dims = [("a", 0, 10, True, None), ("b", 0.0, 1.0, False, None),
            ("c", 0.0, 100.0, False, 12.5), ("d", 4, 4, True, None)]
    sp = space.DesignSpace.of([space.Dimension(n, lo, hi, integer=i,
                                               step=s)
                               for n, lo, hi, i, s in dims])
    jsp = jspace.DesignSpace.of([jspace.Dimension(n, lo, hi, integer=i,
                                                  step=s)
                                 for n, lo, hi, i, s in dims])
    x = np.random.default_rng(0).uniform(-5, 120, size=(32, 4))
    np.testing.assert_array_equal(sp.snap(x), jsp.snap(x))
    snapped = sp.snap(x)
    assert [sp.key(v) for v in snapped] == [jsp.key(v) for v in snapped]
    assert [sp.to_point(v).knobs for v in snapped] \
        == [jsp.to_point(v).knobs for v in snapped]
    knobs = dict(a=3, b=0.25, c=40.0, d=4)
    np.testing.assert_array_equal(sp.from_dict(knobs), jsp.from_dict(knobs))
    np.testing.assert_array_equal(sp.sample(np.random.default_rng(1), 8),
                                  jsp.sample(np.random.default_rng(1), 8))


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_pso_matches_reference_bit_for_bit(seed):
    def f(p):
        return -float(((p - 3.0) ** 2).sum())
    got = particle_swarm(f, [0, 0], [10, 10], [False, True], n_particles=20,
                         n_iters=30, seed=seed)
    want = jpso(f, [0, 0], [10, 10], [False, True], n_particles=20,
                n_iters=30, seed=seed)
    np.testing.assert_array_equal(got.best_position, want.best_position)
    assert got.best_fitness == want.best_fitness
    assert got.history == want.history


def _quad_model(iface_mod):
    class Quad:
        name = "quad"

        def evaluate(self, point):
            x, y = point["x"], point["y"]
            v = 100.0 - ((x - 3.0) ** 2 + (y - 4.0) ** 2)
            return iface_mod.EvalResult(gops=v, throughput=max(v, 1e-9),
                                        latency_s=1.0 / max(v, 1e-9),
                                        efficiency=0.5)
    return Quad()


@pytest.mark.parametrize("strategy", ["pso", "evolutionary",
                                      "random-refine"])
def test_run_search_matches_reference(strategy):
    kw = dict(strategy=strategy, seed=0, n_particles=16, n_iters=20,
              population=16, generations=20)
    got = search.run_search(
        _quad_model(iface),
        space.DesignSpace.of([space.Dimension("x", 0, 10),
                              space.Dimension("y", 0, 10)]), **kw)
    want = jsearch.run_search(
        _quad_model(jiface),
        jspace.DesignSpace.of([jspace.Dimension("x", 0, 10),
                               jspace.Dimension("y", 0, 10)]), **kw)
    _same_search(got, want)
    with pytest.raises(ValueError):
        search.run_search(_quad_model(iface), space.DesignSpace.of(
            [space.Dimension("x", 0, 1)]), strategy="annealing")


@pytest.mark.parametrize("strategy", ["pso", "evolutionary",
                                      "random-refine"])
@pytest.mark.parametrize("net,board,kw", [
    ("alexnet", "KU115", dict(n_particles=8, n_iters=8, max_batch=16)),
    ("alexnet", "KU115", dict(batch=1, fix_batch=True, n_particles=10,
                              n_iters=8)),
    ("alexnet", "KU115", dict(batch=4, fix_batch=True, n_particles=6,
                              n_iters=4)),
    ("vgg16", "KU115", dict(batch=1, fix_batch=True, n_particles=12,
                            n_iters=10)),
    ("resnet18", "ZC706", dict(n_particles=8, n_iters=6, max_batch=16,
                               seed=3)),
])
def test_explore_fpga_matches_reference(net, board, kw, strategy):
    got = engine.explore_fpga(wl.cnn_workload(net), hw.FPGAS[board],
                              strategy=strategy, **kw)
    want = jengine.explore_fpga(jwl.cnn_workload(net), jhw.FPGAS[board],
                                strategy=strategy, **kw)
    _same_search(got.search, want.search)
    _same(got.best_design, want.best_design)
    assert (got.batch_trace, got.sp_trace) == (want.batch_trace,
                                               want.sp_trace)
    _same(got.gops_trace, want.gops_trace)
    assert got.feasible == want.feasible
    space_kw = {k: kw[k] for k in ("max_batch",) if k in kw}
    fixed = kw.get("batch") if kw.get("fix_batch") else None
    sp = engine.fpga_design_space(wl.cnn_workload(net), hw.FPGAS[board],
                                  fixed, **space_kw)
    jsp = jengine.fpga_design_space(jwl.cnn_workload(net),
                                    jhw.FPGAS[board], fixed, **space_kw)
    assert sp.names == jsp.names
    np.testing.assert_array_equal(sp.lo, jsp.lo)
    np.testing.assert_array_equal(sp.hi, jsp.hi)


@pytest.mark.parametrize("paradigm,batch", [(1, 1), (2, 1), (1, None),
                                            (2, 8), (3, 1), (3, None)])
@pytest.mark.parametrize("net,extra", [("vgg16", 0), ("alexnet", 0),
                                       ("vgg16", 5)])
def test_benchmark_paradigm_matches_reference(net, extra, paradigm, batch):
    got = engine.benchmark_paradigm(_layers(wl, net, extra=extra), hw.KU115,
                                    paradigm, batch=batch)
    want = jengine.benchmark_paradigm(_layers(jwl, net, extra=extra),
                                      jhw.KU115, paradigm, batch=batch)
    _same_result(got, want)


def test_paradigm3_dominates_pure_paradigms_in_port():
    layers = _layers(wl, "vgg16")
    p1 = engine.benchmark_paradigm(layers, hw.KU115, 1, batch=1).gops
    p2 = engine.benchmark_paradigm(layers, hw.KU115, 2, batch=1).gops
    res = engine.explore_fpga(layers, hw.KU115, batch=1, fix_batch=True,
                              n_particles=12, n_iters=10)
    assert res.best_design.gops() >= 0.99 * max(p1, p2)
