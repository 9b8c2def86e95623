"""Port pure-SSM family (Mamba-2) against the reference, on the CPU.

* the config of ``mamba2-1.3b`` equals the reference's field by field,
  and so does its parameter count;
* the port's plain chunked SSD scan against the reference's
  ``ssd_chunked`` (the ``xla`` impl), its Pallas kernel in interpret mode
  and its sequential ``ssd_ref``, at ragged lengths and S < chunk;
* the mixer (prefill block and one-token decode step) under both port
  policies against the reference's;
* the smoke model with reference weights (``params_from_numpy``): f32
  logits, and prefill + greedy decode token for token;
* cache specs, the contiguous and paged engines (streams equal to each
  other and to the reference engine's) and the launcher.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.kernels.dispatch import KernelPolicy as JPolicy  # noqa: E402
from repro.kernels.ref import ssd_ref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import ModelRuntime as JRuntime  # noqa: E402
from repro.models.model import cache_spec as jcache_spec  # noqa: E402
from repro.models.model import \
    paged_cache_spec as jpaged_spec  # noqa: E402
from repro.serve import PagedServeEngine as JPaged  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402

from repro_torch.configs import ARCHS, get_arch, smoke_config  # noqa: E402
from repro_torch.kernels import dispatch as D  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan  # noqa: E402
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import (ModelRuntime, cast_params,  # noqa: E402
                                decode_step, decode_step_paged, forward,
                                init_params, params_from_numpy, prefill)
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.model import cache_spec, paged_cache_spec  # noqa
from repro_torch.serve import (PagedServeEngine, Request,  # noqa: E402
                               ServeEngine)

NAME = "mamba2-1.3b"
#: f32, the same chunked algorithm on both sides: only the summation
#: order of the einsums differs.
SCAN_TOL = dict(atol=1e-4, rtol=1e-4)
#: f32 against the Pallas kernel and the sequential recurrence, the
#: reference's own bar for its kernel (``tests/test_kernels.py``): the
#: chunked and the step-by-step sums round differently.
KERNEL_TOL = dict(atol=5e-4, rtol=5e-4)
#: f32 logits relative to the largest logit (two frameworks' matmuls).
LOGIT_RTOL = 1e-4
TPOL = {"torch": D.TORCH_POLICY, "cuda": D.CUDA_POLICY}


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / np.max(np.abs(want)))


def _rt(dtype="float32", kernels=None):
    return ModelRuntime(dtype=dtype, attn_chunk=16, device="cpu",
                        kernels=kernels)


def _jrt():
    return JRuntime(dtype="float32", remat="none", attn_chunk=16)


@pytest.fixture(scope="module")
def model():
    """(cfg, jcfg, jax params, port params) at smoke size."""
    cfg, jcfg = smoke_config(ARCHS[NAME]), jax_smoke(JAX_ARCHS[NAME])
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jcfg, jp, tp


# ===========================================================================
# Config and parameters
# ===========================================================================
@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_matches_reference(smoke):
    ours, ref = ARCHS[NAME], JAX_ARCHS[NAME]
    if smoke:
        ours, ref = smoke_config(ours), jax_smoke(ref)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert ours.attention_layer_indices() == ref.attention_layer_indices()
    assert ours.ssm_layer_indices() == ref.ssm_layer_indices()
    assert get_arch("mamba2_1_3b") is ARCHS[NAME]


def test_params_from_numpy_carries_the_ssm_tree(model):
    cfg, _, jp, tp = model
    assert set(tp["blocks"]) == {"ssm", "ln"}
    for k, v in jp["blocks"]["ssm"].items():
        np.testing.assert_array_equal(tp["blocks"]["ssm"][k].numpy(),
                                      np.asarray(v))
    # the const init: A_log is 0 (A = -1) in the port's own draw too
    own = init_params(cfg, seed=1, device="cpu")
    assert not own["blocks"]["ssm"]["A_log"].any()
    assert (own["blocks"]["ssm"]["D"] == 1).all()


def test_cast_params_keeps_ssm_leaves_f32(model):
    tp = model[3]
    blocks = cast_params(tp, _rt("bfloat16"))["blocks"]
    for k in ("A_log", "dt_bias", "norm"):
        assert blocks["ssm"][k].dtype == torch.float32
    assert blocks["ln"]["scale"].dtype == torch.float32
    assert blocks["ssm"]["in_proj"].dtype == torch.bfloat16
    assert blocks["ssm"]["conv_w"].dtype == torch.bfloat16


# ===========================================================================
# The chunked scan
# ===========================================================================
SCAN_CASES = [  # b, S, nh, hp, N, chunk
    (2, 64, 4, 16, 8, 16),
    (1, 100, 2, 32, 16, 32),     # ragged last chunk
    (2, 8, 3, 16, 8, 32),        # S < chunk (a chunk-mode prompt floor)
    (1, 40, 2, 64, 128, 16),     # mamba2-1.3b head geometry
]


def _scan_inputs(b, S, nh, hp, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, nh, hp)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, nh)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(nh) * 0.5)).astype(np.float32)
    B = rng.standard_normal((b, S, nh, N)).astype(np.float32)
    C = rng.standard_normal((b, S, nh, N)).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("b,S,nh,hp,N,chunk", SCAN_CASES)
def test_ssd_plain_matches_reference(b, S, nh, hp, N, chunk):
    args = _scan_inputs(b, S, nh, hp, N)
    jargs = [jnp.asarray(a) for a in args]
    y, h = ssd_chunked(*map(_t, args), chunk)
    assert y.dtype == torch.float32 and h.shape == (b, nh, hp, N)
    yx, hx = jssm.ssd_chunked(*jargs, chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(yx), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hx), **SCAN_TOL)
    for want_y, want_h in (ssd_scan_pallas(*jargs, chunk=chunk),
                           ssd_ref(*jargs)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y),
                                   **KERNEL_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h),
                                   **KERNEL_TOL)


def test_ssd_plain_carries_an_initial_state():
    x, dt, A, B, C = _scan_inputs(2, 24, 2, 16, 8, seed=3)
    h0 = np.random.default_rng(4).standard_normal((2, 2, 16, 8)) \
        .astype(np.float32)
    y, h = ssd_chunked(*map(_t, (x, dt, A, B, C)), 8, init_state=_t(h0))
    yx, hx = jssm.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), 8,
                              init_state=jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yx), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(hx), **SCAN_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_wrapper_and_policies_take_the_plain_version_on_cpu(dtype):
    x, dt, A, B, C = map(_t, _scan_inputs(1, 20, 2, 16, 8, seed=5))
    x, B, C = x.to(dtype), B.to(dtype), C.to(dtype)
    want = ssd_chunked(x, dt, A, B, C, 8)
    before = ssd_scan.launches
    for got in (ssd_scan(x, dt, A, B, C, chunk=8),
                *(D.dispatch("ssd_scan", pol, x, dt, A, B, C, chunk=8)
                  for pol in TPOL.values())):
        assert got[0].dtype == dtype and got[1].dtype == torch.float32
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ssd_scan.launches == before              # no kernel on the CPU


def test_ssd_wrapper_refuses_a_device_it_cannot_launch_on():
    x, dt, A, B, C = (t.to("meta")
                      for t in map(_t, _scan_inputs(1, 8, 2, 16, 8)))
    with pytest.raises(ValueError, match="tensors on meta"):
        ssd_scan(x, dt, A, B, C, chunk=8)


# ===========================================================================
# The mixer
# ===========================================================================
def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["blocks"]["ssm"]),
            {k: v[0] for k, v in tp["blocks"]["ssm"].items()})


@pytest.mark.parametrize("impl", sorted(TPOL))
def test_ssm_block_matches_reference(model, impl):
    cfg, jcfg, jp, tp = model
    jl, tl = _layer0(jp, tp)
    x = np.random.default_rng(6).standard_normal(
        (2, 37, cfg.d_model)).astype(np.float32)
    want, wst = jssm.ssm_block(jl, jnp.asarray(x), jcfg,
                               policy=JPolicy(ssd_scan="pallas"))
    got, st = tssm.ssm_block(tl, _t(x), cfg, policy=TPOL[impl])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    for k in ("conv", "ssm"):
        assert st[k].shape == wst[k].shape
        np.testing.assert_allclose(st[k].numpy(), np.asarray(wst[k]),
                                   **KERNEL_TOL)


def test_ssm_decode_step_matches_reference(model):
    cfg, jcfg, jp, tp = model
    jl, tl = _layer0(jp, tp)
    rng = np.random.default_rng(7)
    shapes = tssm.ssm_cache_shapes(cfg, 3)
    cache = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    x = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    want, wst = jssm.ssm_decode_step(
        jl, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jcfg)
    got, st = tssm.ssm_decode_step(tl, _t(x), {k: _t(v) for k, v in
                                               cache.items()}, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(wst[k]),
                                   **SCAN_TOL)


# ===========================================================================
# The model with reference weights
# ===========================================================================
def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("impl", sorted(TPOL))
def test_forward_logits_match_reference(model, impl):
    cfg, jcfg, jp, tp = model
    toks = _tokens(cfg, 2, 45)            # two chunks of 32, the last ragged
    want, waux = jforward(jp, jcfg, {"tokens": jnp.asarray(toks)}, _jrt())
    got, aux = forward(tp, cfg, {"tokens": torch.from_numpy(toks)},
                       _rt(kernels=TPOL[impl]))
    assert got.shape == (2, 45, cfg.vocab_size)
    assert _rel_err(got.numpy(), want) < LOGIT_RTOL
    assert float(aux) == float(waux) == 0.0


@pytest.mark.parametrize("impl", sorted(TPOL))
def test_prefill_and_greedy_decode_match_reference(model, impl):
    """Exact-length prefill (the recurrent state would absorb pad) then
    greedy decode steps: tokens identical, logits and state within
    tolerance; ``decode_step_paged`` takes the same path."""
    cfg, jcfg, jp, tp = model
    rt, jrt = _rt(kernels=TPOL[impl]), _jrt()
    toks = _tokens(cfg, 3, 21, seed=1)
    jcache, jlog = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 64, jrt)
    cache, log = prefill(tp, cfg, {"tokens": torch.from_numpy(toks)}, 64, rt)
    assert set(cache) == set(jcache) == {"pos", "conv", "ssm"}
    for n in cache:
        assert tuple(cache[n].shape) == tuple(jcache[n].shape)
    assert cache["ssm"].dtype == torch.float32
    assert _rel_err(log.numpy(), jlog) < LOGIT_RTOL
    jt, tt = jnp.argmax(jlog, -1).astype(jnp.int32), log.argmax(-1)
    for step in range(8):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jcache, jlog = jdecode(jp, jcfg, jcache, jt, jrt)
        if step % 2:
            cache, log = decode_step_paged(tp, cfg, cache, tt, rt,
                                           page_size=8, window=64)
        else:
            cache, log = decode_step(tp, cfg, cache, tt, rt)
        assert _rel_err(log.numpy(), jlog) < LOGIT_RTOL
        jt, tt = jnp.argmax(jlog, -1).astype(jnp.int32), log.argmax(-1)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    np.testing.assert_allclose(cache["ssm"].numpy(),
                               np.asarray(jcache["ssm"]), **KERNEL_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_specs_match_reference(dtype):
    cfg = smoke_config(ARCHS[NAME])
    jcfg = jax_smoke(JAX_ARCHS[NAME])
    for ours, ref in ((cache_spec(cfg, 3, 64, dtype),
                       jcache_spec(jcfg, 3, 64, dtype)),
                      (paged_cache_spec(cfg, 3, 9, 8, 64, dtype),
                       jpaged_spec(jcfg, 3, 9, 8, 64, dtype))):
        assert set(ours) == set(ref)
        for n, (shape, dt) in ours.items():
            assert tuple(shape) == tuple(ref[n][0])
            assert str(dt).replace("torch.", "") == jnp.dtype(ref[n][1]).name


# ===========================================================================
# Serving
# ===========================================================================
TRACE = [(3, 5), (8, 4), (5, 6), (12, 3), (17, 5), (40, 4), (9, 7)]


def _requests(cfg, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), new)
            for n, new in TRACE]


def _streams(eng, mk, reqs):
    for i, (p, new) in enumerate(reqs):
        eng.submit(mk(rid=i, prompt=p, max_new_tokens=new))
    eng.run()
    return {r.rid: list(r.out_tokens) for r in eng.finished}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_streams_equal_contiguous(model, dtype):
    cfg, _, _, tp = model
    reqs = _requests(cfg)
    want = _streams(ServeEngine(tp, cfg, _rt(dtype), n_slots=3, max_len=64),
                    Request, reqs)
    eng = PagedServeEngine(tp, cfg, _rt(dtype), n_slots=3, max_len=64,
                           page_size=8)
    got = _streams(eng, Request, reqs)
    assert got == want and len(got) == len(reqs)
    assert eng.stats.forced_tokens > 0             # chunk-mode admission
    assert eng.stats.prefix_hits == 0 and "kp" not in eng.cache


def test_engines_match_reference_engines(model):
    cfg, jcfg, jp, tp = model
    reqs = _requests(cfg, seed=8)
    want = _streams(JServe(jp, jcfg, _jrt(), n_slots=3, max_len=64),
                    JRequest, reqs)
    assert want == _streams(JPaged(jp, jcfg, _jrt(), n_slots=3, max_len=64,
                                   page_size=8), JRequest, reqs)
    for eng in (ServeEngine(tp, cfg, _rt(), n_slots=3, max_len=64),
                PagedServeEngine(tp, cfg, _rt(), n_slots=3, max_len=64,
                                 page_size=8)):
        assert _streams(eng, Request, reqs) == want


@pytest.mark.parametrize("page_size", ["0", "8"])
def test_launcher_serves_mamba2_on_cpu(capsys, page_size):
    launcher.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
                   "--requests", "3", "--max-new", "4", "--max-len", "32",
                   "--page-size", page_size])
    assert "served 3/3 requests, 12 tokens" in capsys.readouterr().out
