"""Port int8 KV cache against the reference, on the CPU.

The scheme (``quantize_rows``) must give the reference's payloads and
scales bit for bit, as the reference computes them when serving: under
``jax.jit``. The int8 decode ops' plain versions are held against the
reference's ``xla`` implementations and its Pallas kernels in interpret
mode at f32 1e-5 (summation order only). The int8 model and serving
paths run on smoke ``minicpm-2b`` in f32 with the reference's weights:
greedy tokens identical, logits within 1e-4 of the largest logit, and
``logit_parity`` reports within 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import quant as jquant  # noqa: E402
from repro.kernels.dispatch import XLA_POLICY  # noqa: E402
from repro.kernels.dispatch import dispatch as jdispatch  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models.model import ModelRuntime as JRuntime  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.serve.parity import logit_parity as jparity  # noqa: E402

from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.kernels import quant as Q  # noqa: E402
from repro_torch.models import (ModelRuntime, cache_spec,  # noqa: E402
                                decode_step, params_from_numpy, prefill)
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve import logit_parity  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = smoke_config(ARCHS["minicpm-2b"])
JCFG = jax_smoke(JAX_ARCHS["minicpm-2b"])
JRT = JRuntime(dtype="float32", remat="none", attn_chunk=16)
RT = ModelRuntime(dtype="float32", attn_chunk=16, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def both_params():
    jp = jinit(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(CFG, jax.tree.map(np.asarray, jp),
                                 device="cpu")


# ===========================================================================
# The scheme
# ===========================================================================
def _rows_with_edges(rng, dtype):
    x = rng.standard_normal((512, 36, 64)).astype(np.float32)
    x[0, :4] = 0.0                                     # all-zero rows
    # absmax 127 gives scale 1 and 63.5 scale 0.5 exactly: the other
    # values sit on .5 after scaling, so they round half to even
    x[1, 0, :6] = [127.0, 2.5, 0.5, -1.5, -2.5, 3.5]
    x[1, 0, 6:] = 0.0
    x[1, 1, :4] = [63.5, 1.25, -0.25, 0.75]
    x[1, 1, 4:] = 0.0
    return jnp.asarray(x).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_identical_to_jitted_reference(dtype):
    xj = _rows_with_edges(np.random.default_rng(0), dtype)
    want_q, want_s = jax.jit(jquant.quantize_rows)(xj)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    q, s = Q.quantize_rows(xt)
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(want_s.astype(jnp.float32)))
    assert not q[0, :4].any() and not s[0, :4].float().any()
    assert q[1, 0, :6].tolist() == [127, 2, 0, -2, -2, 4]
    assert q[1, 1, :4].tolist() == [127, 2, 0, 2]
    # the f32 scale itself is the jitted one: absmax * f32(1/127)
    am = xt.float().abs().amax(-1)
    jam = jnp.max(jnp.abs(xj.astype(jnp.float32)), axis=-1)
    np.testing.assert_array_equal(
        (am * Q.INV_127).numpy(),
        np.asarray(jax.jit(lambda a: a / 127.0)(jam)))
    if dtype == "bfloat16":
        # the literal division disagrees on these rows: the test can see
        # the difference it guards
        assert bool(((am / 127.0) != am * Q.INV_127).any())


def test_dequantize_rows_matches_reference():
    rng = np.random.default_rng(1)
    q = rng.integers(-127, 128, (3, 5, 2, 16)).astype(np.int8)
    s = jnp.asarray(rng.random((3, 5, 2)).astype(np.float32)) \
        .astype(jnp.bfloat16)
    want = jquant.dequantize_rows(jnp.asarray(q), s)
    got = Q.dequantize_rows(_t(q), _t(np.asarray(s.astype(jnp.float32)))
                            .to(torch.bfloat16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ===========================================================================
# The int8 decode ops' plain versions
# ===========================================================================
def _int8_rows(rng, shape):
    """Payload and bf16 scales of real quantized rows (numpy, f32
    scales rounded to bf16)."""
    q, s = jax.jit(jquant.quantize_rows)(
        jnp.asarray(rng.standard_normal(shape).astype(np.float32)))
    return np.asarray(q), np.asarray(s.astype(jnp.float32))


def _bf16(a):
    return _t(a).to(torch.bfloat16)


@pytest.mark.parametrize("B,Hq,Hkv,Dh,W", [(3, 4, 2, 16, 50),
                                          (2, 2, 2, 64, 130)])
def test_quant_decode_plain_matches_reference(B, Hq, Hkv, Dh, W):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    kq, ks = _int8_rows(rng, (B, W, Hkv, Dh))
    vq, vs = _int8_rows(rng, (B, W, Hkv, Dh))
    mask = np.arange(W)[None, :] <= rng.integers(0, W, B)[:, None]
    jargs = (jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
             jnp.asarray(ks).astype(jnp.bfloat16),
             jnp.asarray(vs).astype(jnp.bfloat16), jnp.asarray(mask))
    want_x = jdispatch("quant_decode_attention", XLA_POLICY, *jargs)
    want_p = jops.quant_decode_attention(*jargs, block_k=16)
    targs = (_t(q), _t(kq), _t(vq), _bf16(ks), _bf16(vs), _t(mask))
    got = Q.quant_decode_attention_plain(*targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_p), **TOL)
    before = Q.quant_decode_attention.launches
    torch.testing.assert_close(Q.quant_decode_attention(*targs), got)
    assert Q.quant_decode_attention.launches == before


@pytest.mark.parametrize("B,Hq,Hkv,Dh,ps,NP,W", [
    (3, 4, 2, 16, 8, 5, 37),     # W not a page multiple: ragged last page
    (2, 2, 2, 64, 16, 9, 144),   # two splits of the kernel's 128 rows
])
def test_quant_paged_decode_plain_matches_reference(B, Hq, Hkv, Dh, ps, NP,
                                                    W):
    rng = np.random.default_rng(3)
    P = B * NP + 1
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    kq, ks = _int8_rows(rng, (P, ps, Hkv, Dh))
    vq, vs = _int8_rows(rng, (P, ps, Hkv, Dh))
    pt = (rng.permutation(P - 1)[: B * NP] + 1).reshape(B, NP) \
        .astype(np.int32)
    pt[0, -1] = 0                                    # a null-page entry
    ar = np.arange(NP * ps)[None, :]
    pos = np.minimum(rng.integers(1, W, B), (NP - 1) * ps - 1)
    mask = (ar <= pos[:, None]) & (ar < W)
    jargs = (jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
             jnp.asarray(ks).astype(jnp.bfloat16),
             jnp.asarray(vs).astype(jnp.bfloat16), jnp.asarray(pt),
             jnp.asarray(mask))
    want_x = jdispatch("quant_paged_decode_attention", XLA_POLICY, *jargs)
    want_p = jops.quant_paged_decode_attention(*jargs, pages_per_block=2)
    targs = (_t(q), _t(kq), _t(vq), _bf16(ks), _bf16(vs), _t(pt), _t(mask))
    got = Q.quant_paged_decode_attention_plain(*targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_p), **TOL)
    before = Q.quant_paged_decode_attention.launches
    torch.testing.assert_close(Q.quant_paged_decode_attention(*targs), got)
    assert Q.quant_paged_decode_attention.launches == before


# ===========================================================================
# The int8 model path
# ===========================================================================
def test_int8_prefill_and_decode_match_reference(both_params):
    """Quantize-at-write prefill, then greedy decode steps over the int8
    contiguous cache: tokens identical, logits within 1e-4, payloads off
    by at most one step where the two frameworks' f32 K rows round
    apart."""
    jp, tp = both_params
    jrt = JRuntime(dtype="float32", remat="none", attn_chunk=16,
                   kv_dtype="int8")
    rt = ModelRuntime(dtype="float32", attn_chunk=16, device="cpu",
                      kv_dtype="int8")
    toks = np.random.default_rng(4).integers(
        0, CFG.vocab_size, (3, 16)).astype(np.int32)
    lengths = np.array([16, 9, 3], np.int32)
    jcache, jlog = jprefill(jp, JCFG, {"tokens": jnp.asarray(toks)}, 40, jrt,
                            lengths=jnp.asarray(lengths))
    cache, log = prefill(tp, CFG, {"tokens": _t(toks)}, 40, rt,
                         lengths=_t(lengths))
    assert set(cache) == set(jcache) == {"pos", "k", "v", "ks", "vs"}
    spec = cache_spec(CFG, 3, 40, "float32", "int8")
    for name, t in cache.items():
        assert (tuple(t.shape), t.dtype) == spec[name]
    for _ in range(5):
        assert np.abs(log.numpy() - np.asarray(jlog)).max() \
            < 1e-4 * np.abs(np.asarray(jlog)).max()
        tt = log.argmax(-1)
        np.testing.assert_array_equal(tt.numpy(),
                                      np.asarray(jnp.argmax(jlog, -1)))
        jcache, jlog = jdecode(jp, JCFG, jcache, jnp.asarray(tt.numpy()),
                               jrt)
        cache, log = decode_step(tp, CFG, cache, tt, rt)
    for name in ("k", "v"):
        diff = np.abs(cache[name].numpy().astype(np.int32)
                      - np.asarray(jcache[name]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    for name in ("ks", "vs"):
        np.testing.assert_allclose(cache[name].float().numpy(),
                                   np.asarray(jcache[name]
                                              .astype(jnp.float32)),
                                   rtol=2 ** -7)


def test_int8_serving_matches_reference_engine(both_params):
    """Contiguous int8 serving: the same streams as the reference's."""
    jp, tp = both_params
    trace = [(3, 5), (12, 3), (17, 5), (40, 4), (9, 7)]
    prompts = [np.random.default_rng(5).integers(
        0, CFG.vocab_size, n).astype(np.int32) for n, _ in trace]
    out = []
    for eng, mk in (
            (JEngine(jp, JCFG, JRuntime(dtype="float32", remat="none",
                                        attn_chunk=16, kv_dtype="int8"),
                     n_slots=3, max_len=64), JRequest),
            (ServeEngine(tp, CFG, ModelRuntime(dtype="float32", attn_chunk=16,
                                               device="cpu", kv_dtype="int8"),
                         n_slots=3, max_len=64), Request)):
        for i, (p, (_, new)) in enumerate(zip(prompts, trace)):
            eng.submit(mk(rid=i, prompt=p, max_new_tokens=new))
        eng.run()
        out.append(({r.rid: (r.out_tokens, r.finish_reason)
                     for r in eng.finished}, eng.kv_cache_bytes()))
    assert out[0] == out[1]


def test_logit_parity_matches_reference(both_params):
    jp, tp = both_params
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
               for n in (11, 5, 17)]
    want = jparity(jp, JCFG, prompts, rt_ref=JRT,
                   rt_test=JRuntime(dtype="float32", remat="none",
                                    attn_chunk=16, kv_dtype="int8"),
                   max_new_tokens=6)
    got = logit_parity(tp, CFG, prompts, rt_ref=RT,
                       rt_test=ModelRuntime(dtype="float32", attn_chunk=16,
                                            device="cpu", kv_dtype="int8"),
                       max_new_tokens=6)
    assert got.n_tokens == want.n_tokens == 3 * 7
    assert abs(got.max_logit_dev - want.max_logit_dev) <= 1e-4
    assert got.token_match_frac == want.token_match_frac
    assert got.within_tol and got.tol == jquant.QUANT_PARITY_TOL
    assert set(got.to_json()) == set(want.to_json())
    same = logit_parity(tp, CFG, prompts, rt_ref=RT, rt_test=RT,
                        max_new_tokens=2)
    assert same.max_logit_dev == 0.0 and same.token_match_frac == 1.0
