"""Port paged serving against the reference, on the CPU.

* the paged decode op's plain version against the reference's ``xla``
  implementation and its Pallas kernel in interpret mode (f32, 1e-5:
  summation order only);
* the host-side allocator and prefix keys: one scripted sequence of
  alloc / retain / release / register / lookup / evict through both
  packages' ``PagedKVCache`` gives the same pages, refcounts, free
  lists and counters, and ``prefix_page_keys`` the same bytes;
* ``PagedServeEngine`` against the reference's on smoke ``minicpm-2b``
  in f32 (page size 8): identical streams, finish reasons and
  ``EngineStats``, prefix cache on and off, bf16-free f32 and int8 KV,
  and the page-budget admission cases of ``tests/test_serve_paged.py``;
* inside the port: paged streams equal contiguous ones (f32 and bf16,
  float and int8 KV), no page leaks, shared prefix pages never written.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.dispatch import XLA_POLICY  # noqa: E402
from repro.kernels.dispatch import dispatch as jdispatch  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models.model import ModelRuntime as JRuntime  # noqa: E402
from repro.serve import PagedKVCache as JPagedKVCache  # noqa: E402
from repro.serve import PagedServeEngine as JPaged  # noqa: E402
from repro.serve import PagesExhausted as JPagesExhausted  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import Scheduler as JScheduler  # noqa: E402
from repro.serve import prefix_page_keys as jkeys  # noqa: E402

from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.kernels import dispatch as D  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import ModelRuntime, params_from_numpy  # noqa: E402
from repro_torch.serve import (PagedKVCache, PagedServeEngine,  # noqa: E402
                               PagesExhausted, Request, Scheduler,
                               ServeEngine, prefix_page_keys)
from repro_torch.serve.paged import equal_hbm_pages  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
CFG = smoke_config(ARCHS["minicpm-2b"])
JCFG = jax_smoke(JAX_ARCHS["minicpm-2b"])


def _jrt(kv_dtype=None):
    return JRuntime(dtype="float32", remat="none", attn_chunk=16,
                    kv_dtype=kv_dtype)


def _rt(dtype="float32", kv_dtype=None):
    return ModelRuntime(dtype=dtype, attn_chunk=16, device="cpu",
                        kv_dtype=kv_dtype)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def both_params():
    jp = jinit(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(CFG, jax.tree.map(np.asarray, jp),
                                 device="cpu")


# ===========================================================================
# The paged decode op
# ===========================================================================
@pytest.mark.parametrize("B,Hq,Hkv,Dh,ps,NP,W", [
    (3, 4, 2, 16, 8, 5, 37),     # W not a page multiple: ragged last page
    (2, 2, 2, 64, 16, 9, 144),   # two splits of the kernel's 128 rows
    (2, 8, 1, 32, 4, 3, 12),     # G = 8
])
def test_paged_decode_plain_matches_reference(B, Hq, Hkv, Dh, ps, NP, W):
    rng = np.random.default_rng(0)
    P = B * NP + 1
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    kp = rng.standard_normal((P, ps, Hkv, Dh)).astype(np.float32)
    vp = rng.standard_normal((P, ps, Hkv, Dh)).astype(np.float32)
    pt = (rng.permutation(P - 1)[: B * NP] + 1).reshape(B, NP) \
        .astype(np.int32)
    pt[-1, -1] = 0                                   # a null-page entry
    ar = np.arange(NP * ps)[None, :]
    pos = np.minimum(rng.integers(1, W, B), (NP - 1) * ps - 1)
    mask = (ar <= pos[:, None]) & (ar < W)
    jargs = tuple(map(jnp.asarray, (q, kp, vp, pt, mask)))
    want_x = jdispatch("paged_decode_attention", XLA_POLICY, *jargs)
    want_p = jops.paged_decode_attention(*jargs, pages_per_block=2)
    targs = tuple(map(_t, (q, kp, vp, pt, mask)))
    got = paged_decode_attention_plain(*targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_p), **TOL)
    before = paged_decode_attention.launches
    for pol in (D.CUDA_POLICY, D.TORCH_POLICY):
        torch.testing.assert_close(
            D.dispatch("paged_decode_attention", pol, *targs,
                       pages_per_block=4, block_k=64), got)
    assert paged_decode_attention.launches == before


# ===========================================================================
# Allocator and prefix keys
# ===========================================================================
def test_prefix_page_keys_byte_identical():
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 50_000, 83).astype(np.int32)
    for ps in (1, 4, 8, 16):
        for n in (None, 0, 3, 100):
            assert prefix_page_keys(toks, ps, n) == jkeys(toks, ps, n)
    assert prefix_page_keys(toks[:7], 8) == []


def _allocator_script(pool_cls, exhausted):
    """One scripted life of a 7-page pool (page size 4); returns every
    observable after every step."""
    rng = np.random.default_rng(2)
    t1 = rng.integers(0, 100, 9)
    t2 = np.concatenate([t1[:4], rng.integers(0, 100, 9)])
    t3 = rng.integers(0, 100, 13)
    pool = pool_cls(7, 4)
    log = []

    def step(tag, fn):
        try:
            out = fn()
        except exhausted:
            out = "exhausted"
        log.append((tag, out, pool._rc.tolist(), list(pool._free),
                    list(pool._prefix.values()), pool.hits, pool.misses,
                    pool.evictions, pool.free_pages, pool.evictable_pages,
                    pool.live_pages, pool.can_allocate(4)))
        return out

    a = step("alloc", lambda: pool.alloc(3))
    step("retain", lambda: pool.retain(a[:1]))
    step("register", lambda: pool.register(t1, a[:2]))
    step("release", lambda: pool.release(a))
    b = step("alloc", lambda: pool.alloc(4))
    h1 = step("lookup", lambda: pool.lookup(t1))
    step("lookup-miss", lambda: pool.lookup(t3))
    h2 = step("lookup-partial", lambda: pool.lookup(t2, max_pages=2))
    step("release", lambda: pool.release(h1 + h2 + a[:1] + b))
    c = step("alloc", lambda: pool.alloc(3))
    step("register", lambda: pool.register(t3, c))
    step("register-dup", lambda: pool.register(t1, c[:1]))
    step("release", lambda: pool.release(c))
    step("alloc-evicts", lambda: pool.alloc(5))
    step("alloc-exhausted", lambda: pool.alloc(2))
    step("double-release", lambda: pool.release([c[0], c[0]]))
    step("retain-free", lambda: pool.retain([pool._free[-1]]))
    step("drop", pool.drop_prefixes)
    return log


def test_allocator_matches_reference_step_by_step():
    ours = _allocator_script(PagedKVCache, PagesExhausted)
    ref = _allocator_script(JPagedKVCache, JPagesExhausted)
    assert ours == ref
    tags = [(s[0], s[1]) for s in ours]
    assert ("alloc-exhausted", "exhausted") in tags
    assert ours[-1][7] > 0                           # evictions happened


def test_equal_hbm_budget_full_width_and_reference():
    """Full width (4 slots, max_len 1024, page size 16): 257 pages of
    bf16 KV, 497 of int8; at smoke size the reference's engine agrees."""
    full = ARCHS["minicpm-2b"]
    assert equal_hbm_pages(full, ModelRuntime(), 4, 64) == 257
    assert equal_hbm_pages(full, ModelRuntime(kv_dtype="int8"), 4, 64) == 497
    assert equal_hbm_pages(full, ModelRuntime(kv_dtype="bfloat16"),
                           4, 64) == 257
    jp = {}                                 # never read by the constructor
    for kv in (None, "bfloat16", "int8"):
        je = JPaged(jp, JCFG, _jrt(kv), n_slots=3, max_len=40, page_size=8)
        assert equal_hbm_pages(CFG, _rt(kv_dtype=kv), 3, 5) == je.n_pages


# ===========================================================================
# The paged engine against the reference's
# ===========================================================================
#: (prompt_len, max_new_tokens): pad buckets, chunk mode past the largest
#: bucket (40), as in tests/test_torch_serve.py.
TRACE = [(3, 5), (8, 4), (5, 6), (12, 3), (17, 5), (40, 4), (9, 7),
         (16, 2), (30, 3)]
STATS = ("prefills", "prefill_tokens", "steps", "occupancy_sum",
         "max_active", "tokens_out", "forced_tokens", "rejected",
         "live_token_steps", "alloc_token_steps", "prefix_hits",
         "prefix_hit_tokens")


def _trace_requests():
    rng = np.random.default_rng(7)
    return [(rng.integers(0, CFG.vocab_size, n).astype(np.int32), new)
            for n, new in TRACE]


def _prefix_requests(sys_len=24, n=5, new=4, seed=9):
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(0, CFG.vocab_size, sys_len)
    return [(np.concatenate([sys_prompt, rng.integers(
        0, CFG.vocab_size, int(rng.integers(3, 9)))]).astype(np.int32), new)
        for _ in range(n)]


def _drive(eng, mk, requests):
    for i, (p, new) in enumerate(requests):
        eng.submit(mk(rid=i, prompt=p, max_new_tokens=new))
    eng.run()
    done = {r.rid: (r.out_tokens, r.finish_reason, r.truncated)
            for r in eng.finished}
    rej = {r.rid: r.finish_reason for r in eng.rejected}
    stats = {k: getattr(eng.stats, k) for k in STATS}
    stats["prefill_shapes"] = len(eng.stats.prefill_traces)
    pages = ((eng.n_pages, eng.pages.live_pages, eng.pages.free_pages,
              eng.pages.hits, eng.pages.misses, eng.pages.evictions)
             if hasattr(eng, "pages") else None)
    return done, rej, stats, pages, eng.kv_cache_bytes()


def _both_paged(both_params, requests, kv_dtype=None, buckets=None, **kw):
    jp, tp = both_params
    kw = dict(dict(n_slots=3, max_len=64, page_size=8), **kw)
    ref = _drive(JPaged(jp, JCFG, _jrt(kv_dtype), scheduler=JScheduler(
        cfg=JCFG, max_len=kw["max_len"], buckets=buckets), **kw),
        JRequest, requests)
    ours = PagedServeEngine(tp, CFG, _rt(kv_dtype=kv_dtype),
                            scheduler=Scheduler(cfg=CFG, max_len=kw["max_len"],
                                                buckets=buckets), **kw)
    return ref, _drive(ours, Request, requests), ours


@pytest.mark.parametrize("requests,prefix,kv_dtype", [
    ("trace", False, None),
    ("trace", True, None),
    ("trace", True, "int8"),
    ("prefix", True, None),
    ("prefix", True, "int8"),
])
def test_paged_engine_matches_reference(both_params, requests, prefix,
                                        kv_dtype):
    if requests == "trace":        # buckets that put 40 in chunk mode
        reqs, buckets = _trace_requests(), (4, 8, 16, 32)
    else:
        reqs, buckets = _prefix_requests(), None
    ref, ours, eng = _both_paged(both_params, reqs, kv_dtype, buckets,
                                 prefix_cache=prefix)
    assert ours == ref
    assert len(eng.finished) == len(reqs)
    if requests == "prefix":
        assert eng.stats.prefix_hits > 0
    else:
        assert eng.stats.forced_tokens > 0


def test_page_budget_queues_instead_of_slots(both_params):
    reqs = [((np.arange(12) + 5 * i).astype(np.int32) % CFG.vocab_size, 4)
            for i in range(6)]
    ref, ours, eng = _both_paged(both_params, reqs, n_slots=4,
                                 page_budget=5, prefix_cache=False)
    assert ours == ref
    assert eng.stats.max_active <= 2 and eng.pages.live_pages == 0


@pytest.mark.parametrize("overflow,budget,new", [("reject", 4, 12),
                                                 ("truncate", 5, 20)])
def test_page_budget_overflow_matches_reference(both_params, overflow,
                                                budget, new):
    """The reference's cases: 20 prompt tokens + ``new`` need more pages
    than the pool holds; reject, or truncate to the pool's 4 * 8 - 20."""
    reqs = [(np.arange(20, dtype=np.int32), new),
            (np.arange(4, dtype=np.int32), 4)]
    ref, ours, eng = _both_paged(both_params, reqs, n_slots=2,
                                 page_budget=budget, overflow=overflow)
    assert ours == ref
    if overflow == "reject":
        assert [r.rid for r in eng.rejected] == [0]
        assert "pool capacity" in eng.rejected[0].finish_reason
    else:
        (r,) = [r for r in eng.finished if r.truncated]
        assert r.rid == 0 and len(r.out_tokens) == 12


def test_page_budget_overflow_error(both_params):
    jp, tp = both_params
    for eng, mk in (
            (JPaged(jp, JCFG, _jrt(), n_slots=1, max_len=64, page_size=8,
                    page_budget=4, overflow="error"), JRequest),
            (PagedServeEngine(tp, CFG, _rt(), n_slots=1, max_len=64,
                              page_size=8, page_budget=4, overflow="error"),
             Request)):
        with pytest.raises(ValueError, match="page budget"):
            eng.submit(mk(rid=0, prompt=np.arange(20, dtype=np.int32),
                          max_new_tokens=12))


# ===========================================================================
# Inside the port
# ===========================================================================
@pytest.mark.parametrize("dtype,kv_dtype", [("float32", None),
                                            ("bfloat16", None),
                                            ("float32", "int8"),
                                            ("bfloat16", "int8")])
def test_paged_streams_equal_contiguous(both_params, dtype, kv_dtype):
    """The reference's invariant: the paged engine's tokens equal the
    contiguous engine's, bit for bit, with slot churn."""
    tp = both_params[1]
    rt = _rt(dtype, kv_dtype)
    reqs = _trace_requests()[:6]
    want = _drive(ServeEngine(tp, CFG, rt, n_slots=3, max_len=64), Request,
                  reqs)[0]
    got = _drive(PagedServeEngine(tp, CFG, rt, n_slots=3, max_len=64,
                                  page_size=8, prefix_cache=False),
                 Request, reqs)[0]
    assert got == want


def test_prefix_cache_no_leak_and_shared_pages_unchanged(both_params):
    """A shared prefix page is never written by its sharers (decode
    lands past the prefix), and refcounts return to zero: after two
    run() waves only registry references remain, and dropping them
    frees every page."""
    tp = both_params[1]
    eng = PagedServeEngine(tp, CFG, _rt(), n_slots=2, max_len=64,
                           page_size=8, prefix_cache=True)
    for i, (p, new) in enumerate(_prefix_requests(n=2, seed=1)):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=new))
    eng.step()                      # admits both: the second one hits
    shared = eng._slot_pages[1][0]
    assert shared and eng.stats.prefix_hits == 1
    snap = {n: eng.cache[n][:, shared].clone() for n in ("kp", "vp")}
    eng.run()
    for n in ("kp", "vp"):
        assert torch.equal(eng.cache[n][:, shared], snap[n])
    for i, (p, new) in enumerate(_prefix_requests(n=3, seed=2)):
        eng.submit(Request(rid=10 + i, prompt=p, max_new_tokens=new))
    eng.run()
    pool = eng.pages
    assert pool.live_pages == pool.evictable_pages > 0
    pool.drop_prefixes()
    assert pool.live_pages == 0 and pool.free_pages == pool.capacity
    assert all(pool.refcount(pg) == 0 for pg in range(1, pool.n_pages))
    assert not eng.cache["pt"].any()         # every row at the null page


def test_paged_model_hands_kernels_contiguous_inputs(both_params,
                                                     monkeypatch):
    """The CUDA wrappers raise on non-contiguous inputs; on the CPU they
    take the plain path, so check every call the paged and int8 paths
    make through the ``cuda`` impls."""
    seen = []
    ops = ("paged_decode_attention", "quant_decode_attention",
           "quant_paged_decode_attention")
    for op in ops:
        impl = D.implementations(op)["cuda"]

        def checked(*arrays, _impl=impl, _op=op, **kw):
            for a in arrays:
                assert a.is_contiguous(), (_op, tuple(a.shape), a.stride())
            seen.append(_op)
            return _impl(*arrays, **kw)

        monkeypatch.setitem(D.implementations(op), "cuda", checked)
    tp = both_params[1]
    reqs = _trace_requests()[:3]
    for kv in (None, "int8"):
        _drive(PagedServeEngine(tp, CFG, _rt(kv_dtype=kv), n_slots=2,
                                max_len=64, page_size=8), Request, reqs)
    _drive(ServeEngine(tp, CFG, _rt(kv_dtype="int8"), n_slots=2,
                       max_len=64), Request, reqs)
    assert set(seen) == set(ops)


def test_launcher_serves_paged_int8_on_cpu(capsys):
    launcher.main(["--arch", "minicpm-2b", "--smoke", "--device", "cpu",
                   "--page-size", "8", "--kv-dtype", "int8", "--requests",
                   "3", "--max-new", "4", "--max-len", "32",
                   "--no-prefix-cache"])
    out = capsys.readouterr().out
    assert "served 3/3 requests, 12 tokens" in out
    assert "(int8)" in out and "paged:" in out and "prefix hits 0" in out
