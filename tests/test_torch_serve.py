"""Port serving stack against the reference on smoke ``minicpm-2b``.

The same request trace goes through the reference ``ServeEngine`` (f32,
``xla`` policy) and the port's (f32 on the CPU, default ``cuda`` policy,
whose wrappers run the plain versions there): greedy token streams and
``finish_reason``s must be identical. The trace covers pad buckets,
chunk mode, batched admission and the three overflow policies.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models.model import ModelRuntime as JRuntime  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import Sampler as JSampler  # noqa: E402
from repro.serve import Scheduler as JScheduler  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402

from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import ModelRuntime, params_from_numpy  # noqa: E402
from repro_torch.serve import (Request, Sampler, Scheduler,  # noqa: E402
                               ServeEngine)
from repro_torch.serve.engine import _splice  # noqa: E402

CFG = smoke_config(ARCHS["minicpm-2b"])
JCFG = jax_smoke(JAX_ARCHS["minicpm-2b"])
JRT = JRuntime(dtype="float32", remat="none", attn_chunk=16)
RT = ModelRuntime(dtype="float32", attn_chunk=16, device="cpu")


@pytest.fixture(scope="module")
def both_params():
    jp = jinit(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(CFG, jax.tree.map(np.asarray, jp),
                                 device="cpu")


#: (prompt_len, max_new_tokens): lengths hit exact buckets, padded
#: buckets (3, 5, 12, 17) and chunk mode past the largest bucket (40).
TRACE = [(3, 5), (8, 4), (5, 6), (12, 3), (17, 5), (40, 4), (9, 7),
         (16, 2), (30, 3)]


def _run_both(both_params, trace, *, max_len=64, n_slots=3,
              admit_width=1, buckets=None, overflow="reject", eos=None):
    jp, tp = both_params
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
               for n, _ in trace]
    out = []
    for side in ("jax", "torch"):
        if side == "jax":
            sched = JScheduler(cfg=JCFG, max_len=max_len, buckets=buckets,
                               admit_width=admit_width)
            eng = JEngine(jp, JCFG, JRT, n_slots=n_slots, max_len=max_len,
                          scheduler=sched, overflow=overflow, eos_id=eos)
            mk = JRequest
        else:
            sched = Scheduler(cfg=CFG, max_len=max_len, buckets=buckets,
                              admit_width=admit_width)
            eng = ServeEngine(tp, CFG, RT, n_slots=n_slots, max_len=max_len,
                              scheduler=sched, overflow=overflow, eos_id=eos)
            mk = Request
        for i, (p, (_, new)) in enumerate(zip(prompts, trace)):
            eng.submit(mk(rid=i, prompt=p, max_new_tokens=new))
        eng.run()
        out.append((eng, sched))
    return out


def _streams(eng):
    done = {r.rid: (r.out_tokens, r.finish_reason, r.truncated)
            for r in eng.finished}
    rej = {r.rid: r.finish_reason for r in eng.rejected}
    return done, rej


@pytest.mark.parametrize("admit_width", [1, 2])
@pytest.mark.parametrize("buckets", [None, (4, 8, 16, 32)])
def test_token_streams_match_reference_engine(both_params, admit_width,
                                              buckets):
    (je, _), (te, sched) = _run_both(both_params, TRACE,
                                     admit_width=admit_width,
                                     buckets=buckets)
    assert _streams(te) == _streams(je)
    assert len(te.finished) == len(TRACE)
    assert te.stats.prefill_compiles <= sched.max_prefill_compiles(
        n_widths=1)
    assert te.stats.prefill_compiles == len(je.stats.prefill_traces)
    assert te.stats.forced_tokens == je.stats.forced_tokens
    assert (te.stats.steps, te.stats.tokens_out, te.stats.max_active) == \
        (je.stats.steps, je.stats.tokens_out, je.stats.max_active)
    if buckets:
        assert te.stats.forced_tokens > 0               # chunk mode ran


@pytest.mark.parametrize("overflow", ["reject", "truncate"])
def test_overflow_policies_match_reference(both_params, overflow):
    trace = [(10, 5), (20, 20), (28, 10), (31, 1), (32, 1), (4, 28)]
    (je, _), (te, _) = _run_both(both_params, trace, max_len=32,
                                 overflow=overflow)
    assert _streams(te) == _streams(je)
    assert te.stats.rejected == je.stats.rejected > 0


def test_overflow_error_policy_raises(both_params):
    jeng = JEngine(both_params[0], JCFG, JRT, n_slots=2, max_len=16,
                   overflow="error")
    eng = ServeEngine(both_params[1], CFG, RT, n_slots=2, max_len=16,
                      overflow="error")
    for e, mk in ((jeng, JRequest), (eng, Request)):
        e.submit(mk(rid=1, prompt=np.ones(10, np.int32), max_new_tokens=6))
        with pytest.raises(ValueError, match="over cache budget"):
            e.submit(mk(rid=0, prompt=np.ones(10, np.int32),
                        max_new_tokens=7))
    assert len(eng.queue) == len(jeng.queue) == 1
    with pytest.raises(ValueError, match="overflow"):
        ServeEngine(both_params[1], CFG, RT, overflow="clamp")


def test_eos_stop_matches_reference(both_params):
    (je, _), _ = _run_both(both_params, TRACE[:4])
    eos = je.finished[0].out_tokens[1]         # a token the run does emit
    (je, _), (te, _) = _run_both(both_params, TRACE[:4], eos=eos)
    assert _streams(te) == _streams(je)
    assert any(r.finish_reason == "stop" for r in te.finished)


def test_run_raises_on_unserved(both_params):
    eng = ServeEngine(both_params[1], CFG, RT, n_slots=1, max_len=32)
    eng.submit(Request(rid=0, prompt=np.ones(4, np.int32),
                       max_new_tokens=8))
    with pytest.raises(RuntimeError, match="never served"):
        eng.run(max_iters=2)


def test_kv_cache_bytes(both_params):
    eng = ServeEngine(both_params[1], CFG, RT, n_slots=3, max_len=40)
    want = 2 * CFG.n_layers * 3 * 40 * CFG.n_kv_heads * CFG.head_dim * 4
    assert eng.kv_cache_bytes() == want


# ---------------------------------------------------------------- _splice
def test_splice_declared_axes_regression():
    """n_layers == n_slots == admitted batch: splice by the declared
    batch axis keeps every layer's own rows (the reference's
    shape-heuristic misfire regression)."""
    L = B = 2
    axes = {"k": (None, "batch", None)}
    big = {"k": torch.zeros(L, B, 3)}
    small = {"k": torch.stack([torch.full((B, 3), 1.0 + i)
                               for i in range(L)])}
    _splice(big, small, [0, 1], rows=[0, 1], axes=axes)
    for i in range(L):
        assert torch.all(big["k"][i] == 1.0 + i)
    pos = {"pos": torch.tensor([5, 6, 7, 8], dtype=torch.int32)}
    _splice(pos, {"pos": torch.tensor([42], dtype=torch.int32)}, 3)
    assert pos["pos"].tolist() == [5, 6, 7, 42]
    with pytest.raises(KeyError, match="declared batch axis"):
        _splice({"junk": torch.zeros(2)}, {"junk": torch.zeros(1)}, 0)


# ---------------------------------------------------------------- copies
def test_sampler_and_scheduler_copies_match_reference():
    rng = np.random.default_rng(3)
    for kw in ({}, {"kind": "temperature", "temperature": 0.7, "top_k": 5,
                    "seed": 11}):
        ours, ref = Sampler(**kw), JSampler(**kw)
        r1, r2 = ours.stream(4), ref.stream(4)
        for _ in range(20):
            logits = rng.standard_normal(64)
            assert ours.sample(logits, r1) == ref.sample(logits, r2)
    for buckets in (None, (), (4, 16)):
        ours = Scheduler(cfg=CFG, max_len=64, buckets=buckets)
        ref = JScheduler(cfg=JCFG, max_len=64, buckets=buckets)
        assert ours.prefill_lengths == ref.prefill_lengths
        for n in range(1, 65):
            assert dataclasses.astuple(ours.plan(n)) == \
                dataclasses.astuple(ref.plan(n))


# ---------------------------------------------------------------- device
def test_engine_and_launcher_refuse_cpu_fallback(both_params, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the no-card path cannot run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(both_params[1], CFG, ModelRuntime(dtype="float32"))
    with pytest.raises(SystemExit) as exc:
        launcher.main(["--arch", "minicpm-2b", "--smoke"])
    assert "no CUDA device" in str(exc.value.code)
    with pytest.raises(SystemExit) as exc:
        launcher.main(["--arch", "gpt-2", "--device", "cpu"])
    assert "available" in str(exc.value.code)


def test_launcher_serves_on_cpu(capsys):
    launcher.main(["--arch", "minicpm_2b", "--smoke", "--device", "cpu",
                   "--requests", "3", "--max-new", "4", "--max-len", "32",
                   "--admit-width", "2"])
    out = capsys.readouterr().out
    assert "served 3/3 requests, 12 tokens" in out
    assert "prefill compiles" in out
