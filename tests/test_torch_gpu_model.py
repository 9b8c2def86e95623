"""The one-card analytic model and its DSE against the reference's TPU
model at one chip, on the CPU.

``repro_torch.core.analytical.gpu_model`` and
``repro_torch.core.dse.gpu_engine`` are the reference's
``tpu_model``/``tpu_engine`` at ``dp = model_axis = pods = 1`` on the
H100's numbers. Every port arch at every ``SHAPES`` entry and at the
shapes ``chip_smoke.py`` runs goes through both, for M in {1, 2, 8},
remat none/full and bf16/int8 storage: the terms, the footprint, the
evaluation and the search's best fitness must agree to 1e-12 relative,
and the reference's collective term must be 0 there.
"""
import dataclasses
import math

import pytest

from repro.configs import get_arch as jget_arch
from repro.configs.base import ShapeConfig as JShape
from repro.core.analytical import tpu_model as jtpu
from repro.core.analytical.interface import DesignPoint as JPoint
from repro.core.dse.tpu_engine import explore_tpu
from repro.core.hardware import TPUSpec
from repro.core.workload import lm_workload as jlm_workload

from repro_torch.configs import SHAPES, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.analytical import gpu_model
from repro_torch.core.analytical.gpu_model import (GPUAnalysis, GPUModel,
                                                   GPUPlan, analyze,
                                                   hbm_footprint)
from repro_torch.core.analytical.interface import DesignPoint
from repro_torch.core.dse import explore_gpu, gpu_design_space
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.workload import lm_workload
from repro_torch.models.model import cache_spec

REL = 1e-12
ARCH_IDS = ("minicpm-2b", "qwen2-moe-a2.7b", "mixtral-8x22b", "mamba2-1.3b",
            "zamba2-2.7b")
#: the reference's chip vocabulary carrying the H100's numbers
H100_AS_TPU = TPUSpec(name=H100_SXM.name,
                      peak_flops_bf16=H100_SXM.peak_flops_bf16,
                      peak_flops_int8=H100_SXM.peak_flops_int8,
                      hbm_bytes=H100_SXM.hbm_bytes, hbm_bw=H100_SXM.hbm_bw)
#: the shapes chip_smoke.py runs: the profiled prefill and decode step,
#: the training runs (B 4, and B 2 for zamba2), by (name, seq, batch,
#: kind, kv_len)
SMOKE_SHAPES = (("prefill_b1_s1024", 1024, 1, "prefill", None),
                ("decode_b4_kv516", 516, 4, "decode", 516),
                ("train_b4_s512", 512, 4, "train", None),
                ("train_b2_s512", 512, 2, "train", None))
ALL_SHAPES = tuple((s.name, s.seq_len, s.global_batch, s.kind, s.kv_len)
                   for s in SHAPES.values()) + SMOKE_SHAPES
#: (arch, n_layers or None): the full configs and the cut training run
CONFIGS = tuple((a, None) for a in ARCH_IDS) + (("qwen2-moe-a2.7b", 2),)
PLANS = tuple((m, r) for m in (1, 2, 8) for r in ("none", "full"))
DTYPES = ((None, None), ("int8", "int8"))


def _close(a, b):
    return math.isclose(a, b, rel_tol=REL, abs_tol=0.0)


def _cfgs(arch, layers):
    tc, jc = get_arch(arch), jget_arch(arch)
    if layers is not None:
        tc = dataclasses.replace(tc, n_layers=layers)
        jc = dataclasses.replace(jc, n_layers=layers)
    return tc, jc


def _shapes(spec):
    return ShapeConfig(*spec), JShape(*spec)


def _unpriced_kv_bytes(cfg, shape, kv_dtype=None):
    """The K/V bytes of the hybrid's attention groups at ``shape``, from
    the port's own cache layout: the reference's ``hbm_footprint`` prices
    K/V only for the dense, moe and vlm families, so a hybrid's inference
    verdict leaves these out (ROADMAP.md, Queue 3)."""
    if cfg.family != "hybrid" or shape.kind == "train":
        return 0.0
    length = shape.kv_len if shape.kind == "decode" and shape.kv_len \
        else shape.seq_len
    spec = cache_spec(cfg, shape.global_batch, length, kv_dtype=kv_dtype)
    return float(sum(math.prod(shp) * dt.itemsize
                     for k, (shp, dt) in spec.items()
                     if k in ("k", "v", "ks", "vs")))


def _ref_plan(m, remat):
    one = jtpu.ShardPlan("IS", "heads", 1)
    return jtpu.TPUPlan(sp=0, front=one, tail=one, microbatches=m,
                        remat=remat, dp=1, pods=1)


def _same_analysis(got, want):
    assert want.collective_s == 0.0
    assert _close(got.compute_s, want.compute_s)
    assert _close(got.memory_s, want.memory_s)
    assert _close(got.step_s, want.step_s)
    assert _close(got.step_s_no_overlap, want.step_s_no_overlap)
    assert got.dominant == want.dominant
    assert len(got.per_op) == len(want.per_op)
    for g, w in zip(got.per_op, want.per_op):
        assert (g["name"], g["kind"]) == (w["name"], w["kind"])
        assert _close(g["compute_s"], w["compute_s"])
        assert _close(g["mem_s"], w["mem_s"])
        assert w["coll_s"] == 0.0


def _cases():
    return [pytest.param(a, layers, spec, id=f"{a}-{layers or 'full'}-"
                         f"{spec[0]}")
            for a, layers in CONFIGS for spec in ALL_SHAPES
            if layers is None or spec[3] == "train"]


@pytest.mark.parametrize("arch,layers,spec", _cases())
def test_analyze_and_footprint_match_reference(arch, layers, spec):
    tc, jc = _cfgs(arch, layers)
    ts, js = _shapes(spec)
    for wdt, kdt in DTYPES:
        wl = lm_workload(tc, ts, weight_dtype=wdt, kv_dtype=kdt)
        jwl = jlm_workload(jc, js, weight_dtype=wdt, kv_dtype=kdt)
        for m, remat in PLANS:
            plan, jplan = GPUPlan(m, remat), _ref_plan(m, remat)
            want = jtpu.analyze(jwl, jplan, chip=H100_AS_TPU)
            _same_analysis(analyze(wl, plan), want)
            if wdt is None:
                _same_analysis(analyze(tc, ts, plan),
                               jtpu.analyze(jc, js, jplan,
                                            chip=H100_AS_TPU))
            got = hbm_footprint(tc, ts, plan, weight_dtype=wdt,
                                kv_dtype=kdt)
            ref = jtpu.hbm_footprint(jc, js, jplan, H100_AS_TPU,
                                     weight_dtype=wdt, kv_dtype=kdt)
            assert sorted(got) == sorted(ref)
            for k in ref:
                if k == "fits":
                    assert got[k] is ref[k]
                else:
                    assert _close(got[k], ref[k]), k


@pytest.mark.parametrize("arch,layers,spec", _cases())
def test_evaluate_matches_reference_at_one_chip(arch, layers, spec):
    tc, jc = _cfgs(arch, layers)
    ts, js = _shapes(spec)
    model = GPUModel(tc, ts)
    ref = jtpu.TPUModel(jc, js, dp=1, model_axis=1, pods=1,
                        chip=H100_AS_TPU)
    for log2_m in range(7):
        for quant in (0, 1):
            got = model.evaluate(DesignPoint.make(log2_m=log2_m,
                                                  quant=quant))
            want = ref.evaluate(JPoint.make(sp=0, log2_m=log2_m,
                                            front_is=1, tail_is=1,
                                            quant=quant))
            assert got.feasible == want.feasible
            # the reference names its dp axis after the same reason
            assert want.reason.startswith(got.reason)
            assert bool(got.reason) == bool(want.reason)
            for f in ("gops", "throughput", "latency_s", "efficiency"):
                assert _close(getattr(got, f), getattr(want, f)), f
            assert sorted(got.resources) == sorted(want.resources)
            for k, v in want.resources.items():
                assert _close(got.resources[k], v), k
            if got.feasible:
                assert want.resources["collective_s"] == 0.0
                _same_analysis(got.detail, want.detail)
            # the sharding knobs the port drops change nothing at one chip
            for sp, front, tail in ((tc.n_layers, 0, 1), (0, 0, 0)):
                alt = ref.evaluate(JPoint.make(sp=sp, log2_m=log2_m,
                                               front_is=front, tail_is=tail,
                                               quant=quant))
                assert _close(alt.efficiency, want.efficiency)
                assert alt.feasible == want.feasible


def _exhaustive_best(model):
    best = 0.0
    for log2_m in range(7):
        for quant in (0, 1):
            r = model.evaluate(DesignPoint.make(log2_m=log2_m, quant=quant))
            best = max(best, r.efficiency if r.feasible else 0.0)
    return best


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_explore_gpu_matches_exhaustive_and_reference(arch, shape):
    tc, jc = get_arch(arch), jget_arch(arch)
    ts = SHAPES[shape]
    js = JShape(ts.name, ts.seq_len, ts.global_batch, ts.kind, ts.kv_len)
    res = explore_gpu(tc, ts)
    ref = explore_tpu(jc, js, dp=1, model_axis=1, pods=1,
                      chip=H100_AS_TPU)
    best = _exhaustive_best(GPUModel(tc, ts))
    assert _close(res.best_fitness, best) or res.best_fitness == best == 0.0
    assert _close(ref.best_fitness, best) or ref.best_fitness == best == 0.0
    assert isinstance(res.best_analysis, GPUAnalysis)
    assert res.best_analysis.compute_s > 0 and res.best_analysis.memory_s > 0
    if best > 0:
        assert res.best_plan.microbatches == ref.best_plan.microbatches
        assert len(res.pareto) >= 1
        assert ts.global_batch % res.best_plan.microbatches == 0
        q = "int8" if res.search.best_point["quant"] >= 0.5 else None
        foot = hbm_footprint(tc, ts, res.best_plan, weight_dtype=q,
                             kv_dtype=q)
        assert foot["fits"]
        if _unpriced_kv_bytes(tc, ts):
            # the hybrid's K/V is not in the verdict: it says the weights
            # and state fit, not that the cache does
            assert "kv_cache" not in foot
    else:
        assert len(res.pareto) == 0
        assert not res.search.best_result.feasible


def test_explore_gpu_known_answers():
    """minicpm-2b and mamba2-1.3b train_4k pick 8 microbatches; one card
    cannot hold qwen2-moe's training or minicpm-2b's 32 x 32k prefill."""
    got = explore_gpu(get_arch("minicpm-2b"), SHAPES["train_4k"])
    assert got.best_plan == GPUPlan(8, "full")
    assert round(got.best_fitness, 4) == 0.6588
    got = explore_gpu(get_arch("mamba2-1.3b"), SHAPES["train_4k"])
    assert got.best_plan.microbatches == 8
    assert round(got.best_fitness, 4) == 0.7651
    for arch, shape in (("qwen2-moe-a2.7b", "train_4k"),
                        ("minicpm-2b", "prefill_32k")):
        got = explore_gpu(get_arch(arch), SHAPES[shape], n_particles=4,
                          n_iters=2)
        assert got.best_fitness == 0.0
        assert "HBM overflow" in got.search.best_result.reason
    for strategy in ("evolutionary", "random-refine"):
        got = explore_gpu(get_arch("minicpm-2b"), SHAPES["train_4k"],
                          strategy=strategy)
        assert _close(got.best_fitness, 0.6587817589141093)


def test_design_space_and_refusals():
    space = gpu_design_space()
    assert space.names == ("log2_m", "quant")
    assert list(space.lo) == [0, 0] and list(space.hi) == [6, 1]
    model = GPUModel(get_arch("minicpm-2b"), SHAPES["train_4k"])
    r = model.evaluate(DesignPoint.make(log2_m=0, quant=1))
    assert r.reason == "int8 storage precision is inference-only"
    model = GPUModel(get_arch("minicpm-2b"), ShapeConfig("t", 512, 3,
                                                         "train"))
    r = model.evaluate(DesignPoint.make(log2_m=1, quant=0))
    assert r.reason == "microbatches=2 indivisible for global_batch=3"
    model = GPUModel(get_arch("mamba2-1.3b"), SHAPES["decode_32k"])
    r = model.evaluate(DesignPoint.make(log2_m=2, quant=0))
    assert r.reason == "microbatching only applies to training"
    r = model.evaluate(DesignPoint.make(log2_m=0, quant=1))
    assert r.feasible
    assert r.resources["logit_dev"] == gpu_model.INT8_LOGIT_DEV_PROXY == 0.02
    assert r.resources["collective_s"] == 0.0
    with pytest.raises(TypeError, match="GPUPlan"):
        analyze(model.workload, object())


def test_smoke_feasibility_verdicts():
    """What chip_smoke.py asserts: every configuration it runs fits one
    card; mixtral-8x22b's prefill and 24-layer qwen2-moe training do
    not."""
    prefill, decode, train4, train2 = (ShapeConfig(*s) for s in SMOKE_SHAPES)
    for arch in ("minicpm-2b", "qwen2-moe-a2.7b", "mamba2-1.3b",
                 "zamba2-2.7b"):
        cfg = get_arch(arch)
        for shape in (prefill, decode):
            foot = hbm_footprint(cfg, shape, GPUPlan())
            assert foot["fits"]
            # with the hybrid's K/V counted, as chip_smoke.py counts it
            assert foot["total"] + _unpriced_kv_bytes(cfg, shape) \
                <= H100_SXM.hbm_bytes
    for arch, layers, shape in (("minicpm-2b", None, train4),
                                ("qwen2-moe-a2.7b", 2, train4),
                                ("mamba2-1.3b", None, train4),
                                ("zamba2-2.7b", None, train2)):
        cfg = _cfgs(arch, layers)[0]
        assert hbm_footprint(cfg, shape, GPUPlan(1, "none"))["fits"]
    foot = hbm_footprint(get_arch("mixtral-8x22b"), prefill, GPUPlan())
    assert not foot["fits"] and round(foot["total"] / 1e9, 1) == 281.5
    foot = hbm_footprint(get_arch("qwen2-moe-a2.7b"), train4,
                         GPUPlan(1, "none"))
    assert not foot["fits"] and round(foot["total"] / 1e9, 2) == 229.85


@pytest.mark.parametrize("shape,kv_dtype", [("prefill_32k", None),
                                            ("decode_32k", None),
                                            ("decode_32k", "int8")])
def test_hybrid_kv_is_not_priced(shape, kv_dtype):
    """The reference's footprint has no K/V term for the hybrid family,
    so zamba2-2.7b's long-context verdicts say it fits one card; its 9
    attention groups' K/V alone (386.5 GB in bf16 at decode_32k) do not.
    The port keeps the reference's numbers (the parity tests above) and
    this pins the gap until the reference counts the hybrid's cache."""
    cfg, ts = get_arch("zamba2-2.7b"), SHAPES[shape]
    foot = hbm_footprint(cfg, ts, GPUPlan(), weight_dtype=kv_dtype,
                         kv_dtype=kv_dtype)
    assert "kv_cache" not in foot and foot["fits"]
    kv = _unpriced_kv_bytes(cfg, ts, kv_dtype)
    assert _close(kv, (cfg.n_layers // cfg.shared_attn_period)
                  * ts.global_batch * ts.seq_len * cfg.n_kv_heads
                  * cfg.head_dim * 2
                  * (1 + (2 / cfg.head_dim if kv_dtype else 1)))
    assert foot["total"] + kv > H100_SXM.hbm_bytes
    if shape == "decode_32k" and kv_dtype is None:
        assert round(kv / 1e9, 1) == 386.5
