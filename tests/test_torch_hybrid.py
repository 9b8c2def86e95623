"""Port hybrid family (Zamba2) against the reference, on the CPU.

Smoke ``zamba2-2.7b`` (4 Mamba-2 layers, a shared attention block after
every 2, alternating between 2 physical blocks) with the reference's
weights crossed through ``params_from_numpy``; the reference runs its
``xla`` path:

* the config field by field and its parameter count; ``param_defs``
  shapes, the ``shared`` subtree included, and the weights crossing;
* f32 logits under both port policies; prefill + greedy decode token
  for token; the cache specs; ``decode_step_paged`` equal to
  ``decode_step``; int8 KV against the reference's int8 path;
* both engines, their streams equal to each other and to the reference
  engines', the prefix cache off for the family;
* ``loss_fn`` and every leaf's gradient against ``jax.grad``, remat
  ``none``/``dots``/``full`` equal; both launchers; the logit
  sensitivity bench's CPU path.

f32 on both sides: logits within 1e-4 of the largest logit (two
frameworks' matmuls, as ``test_torch_ssm.py`` holds them), the loss
within 1e-5 relative and each gradient leaf within 1e-4 of its largest
entry (``test_torch_train.py``'s bars).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models.model import ModelRuntime as JRuntime  # noqa: E402
from repro.models.model import cache_spec as jcache_spec  # noqa: E402
from repro.models.model import param_defs as jdefs  # noqa: E402
from repro.models.model import \
    paged_cache_spec as jpaged_spec  # noqa: E402
from repro.serve import PagedServeEngine as JPaged  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402

from repro_torch.configs import ARCHS, get_arch, smoke_config  # noqa: E402
from repro_torch.kernels import dispatch as D  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import (ModelRuntime, cast_params,  # noqa: E402
                                decode_step, decode_step_paged, forward,
                                init_paged_cache, init_params, loss_fn,
                                param_defs,
                                params_from_numpy, prefill,
                                write_prefill_pages,
                                write_prefill_pages_quant)
from repro_torch.models.model import cache_spec, paged_cache_spec  # noqa
from repro_torch.serve import (PagedServeEngine, Request,  # noqa: E402
                               ServeEngine)
from repro_torch.train.loop import value_and_grad  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

NAME = "zamba2-2.7b"
#: f32 logits relative to the largest logit (two frameworks' matmuls).
LOGIT_RTOL = 1e-4
#: f32 loss relative, and each gradient leaf relative to its largest
#: entry (``tests/test_torch_train.py``).
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
TPOL = {"torch": D.TORCH_POLICY, "cuda": D.CUDA_POLICY}
MAX_LEN = 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / np.max(np.abs(want)))


def _rt(dtype="float32", kernels=None, **kw):
    return ModelRuntime(dtype=dtype, attn_chunk=16, device="cpu",
                        kernels=kernels, **kw)


def _jrt(**kw):
    return JRuntime(dtype="float32", remat="none", attn_chunk=16, **kw)


def _shapes(defs):
    return jax.tree.map(lambda d: tuple(d.shape), defs,
                        is_leaf=lambda x: hasattr(x, "init"))


@pytest.fixture(scope="module")
def model():
    """(cfg, jcfg, jax params, port params) at smoke size."""
    cfg, jcfg = smoke_config(ARCHS[NAME]), jax_smoke(JAX_ARCHS[NAME])
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jcfg, jp, tp


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


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
    assert get_arch("zamba2_2_7b") is ARCHS[NAME]
    assert ours.head_dim == (80 if not smoke else 16)


@pytest.mark.parametrize("smoke", [False, True])
def test_param_defs_match_reference_shapes(smoke):
    cfg, jcfg = ARCHS[NAME], JAX_ARCHS[NAME]
    if smoke:
        cfg, jcfg = smoke_config(cfg), jax_smoke(jcfg)
    ours, ref = param_defs(cfg), jdefs(jcfg)
    assert _shapes(ours) == _shapes(ref)
    assert set(ours) == {"embed", "final_norm", "lm_head", "blocks",
                         "shared"}
    assert ours["shared"]["wq"].shape[0] == cfg.n_shared_attn_blocks


def test_params_from_numpy_carries_the_shared_blocks(model):
    cfg, _, jp, tp = model
    for path, leaf in tree_items(tp):
        want = jp
        for k in path:
            want = want[k]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want))
    assert set(tp["shared"]) == set(jp["shared"])
    blocks = cast_params(tp, _rt("bfloat16"))
    assert blocks["shared"]["ln1"]["scale"].dtype == torch.float32
    assert blocks["shared"]["wq"].dtype == torch.bfloat16
    assert blocks["blocks"]["ssm"]["A_log"].dtype == torch.float32


# ===========================================================================
# The model with reference weights
# ===========================================================================
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


def _greedy(model, rt, jrt, steps=8, B=3, S=21, seed=1):
    """Prefill then greedy decode steps on both sides: the tokens must be
    identical and each step's logits within LOGIT_RTOL. Returns the
    port's and the reference's caches."""
    cfg, jcfg, jp, tp = model
    toks = _tokens(cfg, B, S, seed=seed)
    jcache, jlog = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                            MAX_LEN, jrt)
    cache, log = prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                         MAX_LEN, rt)
    assert _rel_err(log.numpy(), jlog) < LOGIT_RTOL
    jt, tt = jnp.argmax(jlog, -1).astype(jnp.int32), log.argmax(-1)
    for _ in range(steps):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jcache, jlog = jdecode(jp, jcfg, jcache, jt, jrt)
        cache, log = decode_step(tp, cfg, cache, tt, rt)
        assert _rel_err(log.numpy(), jlog) < LOGIT_RTOL
        jt, tt = jnp.argmax(jlog, -1).astype(jnp.int32), log.argmax(-1)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    return cache, jcache


@pytest.mark.parametrize("impl", sorted(TPOL))
def test_prefill_and_greedy_decode_match_reference(model, impl):
    """Exact-length prefill (the recurrent state would absorb pad), then
    greedy decode: the state of every layer and the K/V of every group
    hand off as the reference's do."""
    cache, jcache = _greedy(model, _rt(kernels=TPOL[impl]), _jrt())
    assert set(cache) == set(jcache) == {"pos", "conv", "ssm", "k", "v"}
    for n in cache:
        assert tuple(cache[n].shape) == tuple(jcache[n].shape)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for n in ("ssm", "k", "v"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jcache[n]),
                                   atol=1e-4, rtol=1e-4)


def test_int8_kv_matches_reference_int8_path(model):
    """int8 KV on both sides (rows quantized at write): the same greedy
    tokens, logits within LOGIT_RTOL, the scales of every group."""
    cache, jcache = _greedy(model, _rt(kv_dtype="int8"),
                            _jrt(kv_dtype="int8"))
    assert set(cache) == {"pos", "conv", "ssm", "k", "v", "ks", "vs"}
    assert cache["k"].dtype == torch.int8 and cache["ks"].dtype == \
        torch.bfloat16
    assert tuple(cache["ks"].shape) == tuple(jcache["ks"].shape)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_specs_match_reference(dtype, kv_dtype):
    cfg = smoke_config(ARCHS[NAME])
    jcfg = jax_smoke(JAX_ARCHS[NAME])
    for ours, ref in ((cache_spec(cfg, 3, 64, dtype, kv_dtype),
                       jcache_spec(jcfg, 3, 64, dtype, kv_dtype)),
                      (paged_cache_spec(cfg, 3, 9, 8, 64, dtype, kv_dtype),
                       jpaged_spec(jcfg, 3, 9, 8, 64, dtype, kv_dtype))):
        assert set(ours) == set(ref)
        for n, (shape, dt) in ours.items():
            assert tuple(shape) == tuple(ref[n][0]), n
            assert str(dt).replace("torch.", "") == jnp.dtype(ref[n][1]).name
    groups = cfg.n_layers // cfg.shared_attn_period
    assert cache_spec(cfg, 3, 64, dtype, kv_dtype)["k"][0][0] == groups


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_decode_step_paged_equals_decode_step(model, kv_dtype):
    """The prefill's rows written into scattered pages: every paged step
    gives the contiguous step's logits and state bit for bit."""
    cfg, _, _, tp = model
    rt = _rt(kv_dtype=kv_dtype)
    B, ps = 3, 8
    npp = MAX_LEN // ps
    toks = torch.from_numpy(_tokens(cfg, B, 19, seed=4))
    cache, log = prefill(tp, cfg, {"tokens": toks}, MAX_LEN, rt)
    paged = init_paged_cache(cfg, B, B * npp + 1, ps, MAX_LEN, rt.dtype,
                             kv_dtype, device="cpu")
    perm = torch.randperm(B * npp, generator=torch.Generator().manual_seed(0))
    paged["pt"].copy_((perm + 1).reshape(B, npp))
    if kv_dtype == "int8":
        write_prefill_pages_quant(
            paged["kp"], paged["vp"], paged["ks"], paged["vs"], cache["k"],
            cache["v"], cache["ks"], cache["vs"], paged["pt"], page_size=ps)
    else:
        write_prefill_pages(paged["kp"], paged["vp"], cache["k"],
                            cache["v"], paged["pt"], page_size=ps)
    for n in ("pos", "conv", "ssm"):
        paged[n].copy_(cache[n])
    tok = log.argmax(-1)
    for _ in range(6):
        cache, log = decode_step(tp, cfg, cache, tok, rt)
        paged, plog = decode_step_paged(tp, cfg, paged, tok, rt,
                                        page_size=ps, window=MAX_LEN)
        assert torch.equal(plog, log)
        tok = log.argmax(-1)
    for n in ("pos", "conv", "ssm"):
        assert torch.equal(paged[n], cache[n]), n


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


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_streams_equal_contiguous(model, dtype, kv_dtype):
    cfg, _, _, tp = model
    reqs = _requests(cfg)
    rt = _rt(dtype, kv_dtype=kv_dtype)
    want = _streams(ServeEngine(tp, cfg, rt, n_slots=3, max_len=MAX_LEN),
                    Request, reqs)
    eng = PagedServeEngine(tp, cfg, rt, n_slots=3, max_len=MAX_LEN,
                           page_size=8)
    got = _streams(eng, Request, reqs)
    assert got == want and len(got) == len(reqs)
    assert eng.stats.forced_tokens > 0             # chunk-mode admission
    assert not eng._prefix_on and eng.stats.prefix_hits == 0
    assert eng.cache["kp"].shape[0] == cfg.n_layers // cfg.shared_attn_period
    assert eng.pages.live_pages == 0               # every page freed


def test_engines_match_reference_engines(model):
    cfg, jcfg, jp, tp = model
    reqs = _requests(cfg, seed=8)
    want = _streams(JServe(jp, jcfg, _jrt(), n_slots=3, max_len=MAX_LEN),
                    JRequest, reqs)
    assert want == _streams(JPaged(jp, jcfg, _jrt(), n_slots=3,
                                   max_len=MAX_LEN, page_size=8),
                            JRequest, reqs)
    for eng in (ServeEngine(tp, cfg, _rt(), n_slots=3, max_len=MAX_LEN),
                PagedServeEngine(tp, cfg, _rt(), n_slots=3, max_len=MAX_LEN,
                                 page_size=8)):
        assert _streams(eng, Request, reqs) == want


@pytest.mark.parametrize("argv", [["--page-size", "0"],
                                  ["--page-size", "8", "--kv-dtype", "int8"]])
def test_serve_launcher_serves_zamba2_on_cpu(capsys, argv):
    serve_launcher.main(["--arch", NAME, "--smoke", "--device", "cpu",
                         "--requests", "3", "--max-new", "4", "--max-len",
                         "32", *argv])
    assert "served 3/3 requests, 12 tokens" in capsys.readouterr().out


# ===========================================================================
# Training
# ===========================================================================
def _batch(cfg, seed=0, b=2, s=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32)}


@pytest.fixture(scope="module")
def jax_grads(model):
    _, jcfg, jp, _ = model
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, jcfg, b, _jrt()), has_aux=True))(jp, batch)
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("impl", sorted(TPOL))
def test_loss_and_grads_match_jax_grad(model, jax_grads, impl):
    cfg, _, _, tp = model
    jl, jg = jax_grads
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, metrics, grads = value_and_grad(
        cfg, _rt(kernels=TPOL[impl], remat="none"), tp, batch)
    assert abs(float(loss) - jl) <= LOSS_RTOL * abs(jl)
    assert float(metrics["aux"]) == 0.0
    assert float(loss_fn(tp, cfg, batch, _rt())[0]) == pytest.approx(
        float(loss), rel=LOSS_RTOL)
    want = dict(tree_items(jg))
    got = dict(tree_items(grads))
    assert got.keys() == want.keys()
    assert any(p[0] == "shared" for p in got)
    for path, w in want.items():
        d = float(np.max(np.abs(got[path].numpy() - w)))
        assert d <= GRAD_RTOL * float(np.max(np.abs(w))), (path, d)


def test_remat_modes_give_equal_grads(model):
    cfg, _, _, tp = model
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 1).items()}
    base = None
    for remat in ("none", "dots", "full"):
        loss, _, grads = value_and_grad(
            cfg, _rt(kernels=D.CUDA_POLICY, remat=remat), tp, batch)
        if base is None:
            base = (loss, grads)
            continue
        assert torch.equal(loss, base[0]), remat
        for (path, g), (_, g0) in zip(tree_items(grads),
                                      tree_items(base[1])):
            assert torch.equal(g, g0), (remat, path)


def test_train_launcher_trains_zamba2_on_cpu(capsys):
    train_launcher.main(["--arch", NAME, "--smoke", "--device", "cpu",
                         "--steps", "3", "--batch", "2", "--seq", "16"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={NAME} params=")
    assert lines[-1].startswith("done: loss ") and "(3 steps" in lines[-1]


def test_logit_sensitivity_bench_on_cpu_and_without_a_card(monkeypatch,
                                                          capsys):
    """The bench's teacher-forced logits run at smoke size on the CPU
    (where both policies take the plain versions, so they agree
    exactly); its entry point refuses without a card."""
    from repro_torch.bench import logit_sensitivity as bench
    cfg = smoke_config(ARCHS[NAME])
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 12))
    forced = torch.from_numpy(_tokens(cfg, 3, 2, seed=2))
    outs = [bench.forced_logits(params, cfg, _rt(kernels=pol), toks, forced)
            for pol in TPOL.values()]
    assert outs[0].shape == (4, 2, cfg.vocab_size)
    assert torch.equal(outs[0], outs[1])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
