"""Port MoE family against the reference, on the CPU.

* the configs of ``qwen2-moe-a2.7b`` and ``mixtral-8x22b`` equal the
  reference's field by field, and so do their parameter counts;
* ``sort_by_expert`` gives the reference's padded rows, block experts,
  inverse index and static bound, bit for bit;
* the grouped GEMM's plain versions against the reference's Pallas
  kernel in interpret mode and its ``xla`` gather einsum (f32, 1e-4 as
  ``tests/test_kernels.py`` holds the Pallas kernel);
* routing: identical top-k indices (a forced tie included) and gates;
* ``moe_ffn`` dropless and capacity, the port's ``torch``/``cuda``
  policies against the reference's ``xla``/``pallas`` ones;
* smoke models with reference weights (``params_from_numpy``): f32
  logits and aux loss, and prefill + greedy decode token for token;
* paged streams equal contiguous ones, and the engine equals the
  reference's.

f32 logits agree within 1e-4 relative to the largest logit (two
frameworks' matmuls, summed in different orders).
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
from repro.kernels.moe_gemm import grouped_gemm_padded as jgrouped  # noqa
from repro.kernels.moe_gemm import sort_by_expert as jsort  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models.model import ModelRuntime as JRuntime  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402

from repro_torch.configs import ARCHS, get_arch, smoke_config  # noqa: E402
from repro_torch.kernels import dispatch as D  # noqa: E402
from repro_torch.kernels.moe_gemm import (  # noqa: E402
    BLOCK_M, block_rows, grouped_gemm_padded, grouped_gemm_padded_plain,
    moe_gemm, moe_gemm_plain, sort_by_expert)
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import (ModelRuntime, cast_params,  # noqa: E402
                                decode_step, forward, init_params,
                                params_from_numpy, prefill)
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.serve import (PagedServeEngine, Request,  # noqa: E402
                               ServeEngine)

ARCH_IDS = ("qwen2-moe-a2.7b", "mixtral-8x22b")
#: f32: the two sides sum in different orders, nothing else differs
#: (the reference's own bar for its Pallas grouped GEMM).
GEMM_TOL = dict(atol=1e-4, rtol=1e-4)
LOGIT_RTOL = 1e-4
JPOL = {"xla": JPolicy.xla(), "pallas": JPolicy(moe_gemm="pallas")}
TPOL = {"torch": D.TORCH_POLICY, "cuda": D.CUDA_POLICY}


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / np.max(np.abs(want)))


def _rt(dropless=True, dtype="float32", kernels=None):
    return ModelRuntime(dtype=dtype, attn_chunk=16, device="cpu",
                        moe_dropless=dropless, kernels=kernels)


def _jrt(dropless=True):
    return JRuntime(dtype="float32", remat="none", attn_chunk=16,
                    moe_dropless=dropless)


@pytest.fixture(scope="module")
def models():
    """{arch: (cfg, jcfg, jax params, port params)} at smoke size."""
    out = {}
    for name in ARCH_IDS:
        cfg, jcfg = smoke_config(ARCHS[name]), jax_smoke(JAX_ARCHS[name])
        jp = jinit(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
        out[name] = (cfg, jcfg, jp, tp)
    return out


# ===========================================================================
# Configs
# ===========================================================================
@pytest.mark.parametrize("name", ARCH_IDS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_matches_reference(name, smoke):
    ours, ref = ARCHS[name], JAX_ARCHS[name]
    if smoke:
        ours, ref = smoke_config(ours), jax_smoke(ref)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert ours.param_count(active_only=True) == ref.active_param_count()
    assert get_arch(name.replace("-", "_")) is ARCHS[name]


# ===========================================================================
# Sorting and the grouped GEMM
# ===========================================================================
SORT_CASES = [  # T, E, bm
    (16, 60, BLOCK_M),  # qwen2-moe decode: 4 slots x top-4 over 60 experts
    (16, 60, 16),
    (64, 4, 64),       # smoke prefill
    (37, 5, 16),       # ragged groups
    (9, 3, 4),
]


@pytest.mark.parametrize("T,E,bm", SORT_CASES)
def test_sort_by_expert_matches_reference(T, E, bm):
    rng = np.random.default_rng(T + E)
    x = (rng.standard_normal((T, 3)) + 1.0).astype(np.float32)
    eor = rng.integers(0, E, T).astype(np.int32)
    eor[eor == 1] = 0                               # an empty expert
    want = jsort(jnp.asarray(x), jnp.asarray(eor), E, bm)
    x_pad, be, inv, Tp = sort_by_expert(_t(x), _t(eor), E, bm)
    assert Tp == want[3] and x_pad.shape[0] == Tp
    np.testing.assert_array_equal(x_pad.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(be.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(want[2]))
    assert be.dtype == torch.int32
    np.testing.assert_array_equal(x_pad[inv].numpy(), x)   # round trip
    rows = block_rows(inv, Tp // bm, bm).numpy()
    assert rows.sum() == T and rows.max() <= bm
    # trailing blocks, and only they, name no expert and hold no row
    assert np.array_equal(be.numpy() == E, rows == 0)
    assert (be.numpy() == E).any()


@pytest.mark.parametrize("T,d,f,E,bm", [
    (64, 32, 48, 4, 16),     # the reference's case, f not a 64 multiple
    (100, 16, 64, 3, 16),
    (128, 64, 128, 8, 64),
])
def test_grouped_gemm_plain_matches_reference(T, d, f, E, bm):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = rng.standard_normal((E, d, f)).astype(np.float32)
    eor = rng.integers(0, E, T).astype(np.int32)
    jx, jw, je = map(jnp.asarray, (x, w, eor))
    xs, be, inv, _ = jsort(jx, je, E, bm)
    want_p = np.asarray(jgrouped(xs, jw, be, block_f=16)[inv])
    want_x = np.asarray(jnp.einsum("td,tdf->tf", jx, jw[je]))
    x_pad, tbe, tinv, Tp = sort_by_expert(_t(x), _t(eor), E, bm)
    rows = block_rows(tinv, Tp // bm, bm)
    got = grouped_gemm_padded_plain(x_pad, _t(w), tbe, rows)
    before = grouped_gemm_padded.launches
    assert torch.equal(grouped_gemm_padded(x_pad, _t(w), tbe, rows), got)
    assert grouped_gemm_padded.launches == before     # no kernel on the CPU
    np.testing.assert_allclose(got[tinv].numpy(), want_p, **GEMM_TOL)
    np.testing.assert_allclose(got[tinv].numpy(), want_x, **GEMM_TOL)
    pad = torch.ones(Tp, dtype=torch.bool)
    pad[tinv] = False
    assert not got[pad].any()                        # padding rows stay 0
    for fn in (moe_gemm, moe_gemm_plain):
        np.testing.assert_allclose(
            fn(_t(x), _t(w), _t(eor), n_experts=E).numpy(), want_x,
            **GEMM_TOL)


def test_moe_gemm_bf16_rounds_once():
    """bf16 rows: f32 products, one rounding, as the Pallas body."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(40, 32, generator=g).to(torch.bfloat16)
    w = torch.randn(5, 32, 24, generator=g).to(torch.bfloat16)
    eor = torch.randint(0, 5, (40,), generator=g)
    want = torch.einsum("td,tdf->tf", x.float(), w.float()[eor]) \
        .to(torch.bfloat16)
    for fn in (moe_gemm, moe_gemm_plain):
        got = fn(x, w, eor, n_experts=5)
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want.float(), atol=1e-5,
                                   rtol=2 ** -7)


# ===========================================================================
# Routing and the MoE layer
# ===========================================================================
def _moe_inputs(models, name, T=24, tie=False):
    cfg, jcfg, jp, tp = models[name]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, T // 2, cfg.d_model)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    tl = {k: v[0] for k, v in tp["blocks"]["moe"].items()}
    if tie:        # experts 1 and 2 get identical router columns
        r = np.array(jl["router"])
        r[:, 2] = r[:, 1]
        jl = dict(jl, router=jnp.asarray(r))
        tl = dict(tl, router=_t(r))
    return cfg, jcfg, x, jl, tl


@pytest.mark.parametrize("tie", [False, True])
def test_route_matches_reference(models, tie):
    cfg, jcfg, x, jl, tl = _moe_inputs(models, "qwen2-moe-a2.7b", tie=tie)
    xt = x.reshape(-1, cfg.d_model)
    jg, ji, ja = jmoe._route(jl, jnp.asarray(xt), jcfg)
    tg, ti, ta = tmoe._route(tl, _t(xt), cfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    if tie:        # experts 1 and 2 tie on every token: 1 ranks first
        has1, has2 = (ti == 1).any(-1), (ti == 2).any(-1)
        assert has1.any()
        assert not (has2 & ~has1).any()
        rank = torch.arange(ti.shape[1])
        at = (lambda e: torch.where(ti == e, rank, ti.shape[1]).min(-1).values)
        assert (at(1)[has2] < at(2)[has2]).all()


@pytest.mark.parametrize("name", ARCH_IDS)
@pytest.mark.parametrize("dropless,token_chunk", [(True, 0), (False, 0),
                                                  (False, 6)])
def test_moe_ffn_matches_reference(models, name, dropless, token_chunk):
    cfg, jcfg, x, jl, tl = _moe_inputs(models, name)
    outs = {}
    for jname, jpol in JPOL.items():
        outs[jname] = jmoe.moe_ffn(jl, jnp.asarray(x), jcfg, dropless=dropless,
                                   token_chunk=token_chunk, policy=jpol)
    np.testing.assert_allclose(np.asarray(outs["xla"][0]),
                               np.asarray(outs["pallas"][0]), atol=1e-5)
    for tname, tpol in TPOL.items():
        got, aux = tmoe.moe_ffn(tl, _t(x), cfg, dropless=dropless,
                                token_chunk=token_chunk, policy=tpol)
        for want, waux in outs.values():
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       **GEMM_TOL)
            np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


def test_capacity_path_drops_like_reference(models):
    """A router that sends every token to expert 0 overflows its
    capacity: the dropped tokens' routed output is zero on both sides."""
    cfg, jcfg, x, jl, tl = _moe_inputs(models, "mixtral-8x22b")
    r = np.zeros_like(np.array(jl["router"]))
    r[:, 0] = 5.0
    jl, tl = dict(jl, router=jnp.asarray(r)), dict(tl, router=_t(r))
    xp = np.abs(x)                          # positive rows: 0 always wins
    want, _ = jmoe.moe_ffn(jl, jnp.asarray(xp), jcfg)
    got, _ = tmoe.moe_ffn(tl, _t(xp), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEMM_TOL)
    assert (np.abs(np.asarray(want)).sum(-1) == 0).any()   # some dropped


# ===========================================================================
# Models with reference weights
# ===========================================================================
def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", ARCH_IDS)
@pytest.mark.parametrize("dropless", [False, True])
def test_forward_logits_and_aux_match_reference(models, name, dropless):
    cfg, jcfg, jp, tp = models[name]
    toks = _tokens(cfg, 2, 19)
    want, waux = jforward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                          _jrt(dropless))
    for pol in TPOL.values():
        got, aux = forward(tp, cfg, {"tokens": torch.from_numpy(toks)},
                           _rt(dropless, kernels=pol))
        assert got.shape == (2, 19, cfg.vocab_size)
        assert _rel_err(got.numpy(), want) < LOGIT_RTOL
        np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)
        assert float(aux) > 0


@pytest.mark.parametrize("name", ARCH_IDS)
@pytest.mark.parametrize("impl", sorted(TPOL))
def test_prefill_and_greedy_decode_match_reference(models, name, impl):
    """Right-padded prefill with ``lengths=`` (dropless, as served) then
    greedy decode steps: tokens identical, logits within tolerance. The
    window of smoke mixtral (32) wraps during the steps."""
    cfg, jcfg, jp, tp = models[name]
    rt, jrt = _rt(kernels=TPOL[impl]), _jrt()
    max_len, S, steps = 48, 28, 8
    toks = _tokens(cfg, 3, S, seed=1)
    lengths = np.array([28, 9, 3], np.int32)
    for j, n in enumerate(lengths):
        toks[j, n:] = 0
    jcache, jlog = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                            max_len, jrt, lengths=jnp.asarray(lengths))
    cache, log = prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                         max_len, rt, lengths=torch.from_numpy(lengths))
    assert set(cache) == set(jcache)
    for n in cache:
        assert tuple(cache[n].shape) == tuple(jcache[n].shape)
    jt, tt = jnp.argmax(jlog, -1).astype(jnp.int32), log.argmax(-1)
    assert _rel_err(log.numpy(), jlog) < LOGIT_RTOL
    for _ in range(steps):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jcache, jlog = jdecode(jp, jcfg, jcache, jt, jrt)
        cache, log = decode_step(tp, cfg, cache, tt, rt)
        assert _rel_err(log.numpy(), jlog) < LOGIT_RTOL
        jt, tt = jnp.argmax(jlog, -1).astype(jnp.int32), log.argmax(-1)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_params_from_numpy_carries_the_moe_tree(models):
    cfg, _, jp, tp = models["qwen2-moe-a2.7b"]
    for k, v in jp["blocks"]["moe"].items():
        np.testing.assert_array_equal(tp["blocks"]["moe"][k].numpy(),
                                      np.asarray(v))
    assert set(tp["blocks"]["moe"]) == {"router", "wi", "wg", "wo",
                                        "shared_wi", "shared_wg",
                                        "shared_wo", "shared_gate"}
    assert "wg" not in tp["blocks"] and "wo2" not in tp["blocks"]


def test_cast_params_keeps_router_and_gate_f32(models):
    tp = models["qwen2-moe-a2.7b"][3]
    rt = ModelRuntime(dtype="bfloat16", device="cpu")
    cast = cast_params(tp, rt)
    moe = cast["blocks"]["moe"]
    assert moe["wg"].dtype == moe["shared_wo"].dtype == torch.bfloat16
    assert moe["router"].dtype == moe["shared_gate"].dtype == torch.float32
    direct = init_params(smoke_config(ARCHS["qwen2-moe-a2.7b"]), seed=3,
                         device="cpu", rt=rt)
    master = init_params(smoke_config(ARCHS["qwen2-moe-a2.7b"]), seed=3,
                         device="cpu")
    flat = jax.tree_util.tree_leaves_with_path
    for (pa, a), (pb, b) in zip(flat(direct), flat(cast_params(master, rt))):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)


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


@pytest.mark.parametrize("name", ARCH_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_streams_equal_contiguous(models, name, dtype):
    cfg, _, _, tp = models[name]
    rt = _rt(dtype=dtype)
    reqs = _requests(cfg)
    want = _streams(ServeEngine(tp, cfg, rt, n_slots=3, max_len=64),
                    Request, reqs)
    got = _streams(PagedServeEngine(tp, cfg, rt, n_slots=3, max_len=64,
                                    page_size=8, prefix_cache=False),
                   Request, reqs)
    assert got == want and len(got) == len(reqs)


def test_engine_matches_reference_engine(models):
    cfg, jcfg, jp, tp = models["qwen2-moe-a2.7b"]
    reqs = _requests(cfg, seed=8)
    want = _streams(JServe(jp, jcfg, _jrt(), n_slots=3, max_len=64),
                    JRequest, reqs)
    got = _streams(ServeEngine(tp, cfg, _rt(), n_slots=3, max_len=64),
                   Request, reqs)
    assert got == want


def test_launcher_serves_moe_on_cpu(capsys):
    launcher.main(["--arch", "qwen2_moe_a2_7b", "--smoke", "--device", "cpu",
                   "--requests", "3", "--max-new", "4", "--max-len", "32",
                   "--page-size", "8"])
    out = capsys.readouterr().out
    assert "served 3/3 requests, 12 tokens" in out and "paged:" in out
