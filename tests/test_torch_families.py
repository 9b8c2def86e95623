"""The five families the port took last, against the reference, on the CPU.

``chatglm3-6b`` (2d RoPE: a partial standard rotation, G 16),
``starcoder2-3b`` (LayerNorm, GELU MLP, G 12), ``stablelm-12b`` (LayerNorm,
qk-norm, a quarter of head dim 160 rotating), ``qwen2-vl-7b`` (M-RoPE over
(3, B, S) positions, patch embeddings in place of tokens) and
``hubert-xlarge`` (a non-causal encoder on frame embeddings, no decode),
each at smoke size with the reference's weights crossed through
``params_from_numpy``; the reference runs its ``xla`` path:

* the configs field by field and their parameter counts; ``param_defs``
  shapes at smoke size and at full width (shapes only: nothing is
  allocated), the LayerNorm ``bias`` and GELU-MLP leaves crossing;
* f32 forward logits under both port policies (qwen2-vl on distinct
  seeded M-RoPE components, so the sections matter); prefill + 8 greedy
  decode steps; paged == contiguous; int8 KV against the reference's
  int8 path; both engines against the reference engines;
* hubert refused by the engine and the serve launcher;
* LayerNorm, and GELU in the tanh form (which the erf form fails);
* the decode ops' plain versions at G 12 and 16 and at head dim 160;
* ``loss_fn`` gradients against ``jax.grad`` (starcoder2: LayerNorm and
  GELU; qwen2-vl: M-RoPE and embeddings);
* the trace front-end against the JAX trace per matmul group.

f32 on both sides: forward logits within ``F32_TOL``; the decode
path's logits within 1e-4 of the largest logit (two frameworks' matmuls,
as ``test_torch_model.py`` holds them); the loss within 1e-5 relative
and each gradient leaf within 1e-4 of its largest entry
(``test_torch_train.py``'s bars); the decode ops within 1e-5.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import shape_skip_reason as jskip  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.core.workload import trace_workload as jtrace  # noqa: E402
from repro.kernels.dispatch import XLA_POLICY  # noqa: E402
from repro.kernels.dispatch import dispatch as jdispatch  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import loss_fn as jloss  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models.layers import layernorm as jlayernorm  # noqa: E402
from repro.models.model import ModelRuntime as JRuntime  # noqa: E402
from repro.models.model import param_defs as jdefs  # noqa: E402
from repro.serve import PagedServeEngine as JPaged  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServe  # noqa: E402

from repro_torch.configs import (ARCHS, SHAPES, get_arch,  # noqa: E402
                                 shape_skip_reason, smoke_config)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.workload import trace_workload  # noqa: E402
from repro_torch.kernels import dispatch as D  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import (ModelRuntime, cast_params,  # noqa: E402
                                decode_step, decode_step_paged, forward,
                                init_paged_cache, param_defs,
                                params_from_numpy, prefill,
                                write_prefill_pages,
                                write_prefill_pages_quant)
from repro_torch.models.layers import gelu, layernorm  # noqa: E402
from repro_torch.serve import (PagedServeEngine, Request,  # noqa: E402
                               ServeEngine)
from repro_torch.train.loop import value_and_grad  # noqa: E402
from repro_torch.tree import tree_items  # noqa: E402

NEW = ("chatglm3-6b", "starcoder2-3b", "stablelm-12b", "qwen2-vl-7b",
       "hubert-xlarge")
DECODERS = NEW[:4]
#: Kernel-versus-plain f32 bar (``chip_smoke.py``), held here by the
#: forward logits of two frameworks at smoke size.
F32_TOL = dict(atol=5e-5, rtol=1e-5)
#: f32 decode-path logits relative to the largest logit.
LOGIT_RTOL = 1e-4
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
#: The decode ops' plain versions against the reference's ``xla`` ops.
OP_TOL = dict(atol=1e-5, rtol=1e-5)
TPOL = {"torch": D.TORCH_POLICY, "cuda": D.CUDA_POLICY}
MAX_LEN = 64


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


_MODELS = {}


def _model(name):
    """(cfg, jcfg, jax params, port params) of ``name`` at smoke size,
    built once per process."""
    if name not in _MODELS:
        cfg, jcfg = smoke_config(ARCHS[name]), jax_smoke(JAX_ARCHS[name])
        jp = jinit(jax.random.PRNGKey(0), jcfg)
        tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
        _MODELS[name] = cfg, jcfg, jp, tp
    return _MODELS[name]


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _batch(cfg, B, S, seed=0):
    """numpy inputs of ``forward``: tokens, or embeddings for a patch or
    frame front-end; M-RoPE takes three distinct position components
    (temporal steps of 4, height and width over a 4 x 4 grid), which
    identical components would reduce to standard RoPE."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "token":
        out = {"tokens": _tokens(cfg, B, S, seed)}
    else:
        out = {"embeds": rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)}
    if cfg.rope == "mrope":
        i = np.arange(S)
        grid = np.stack([i // 16 * 4, i // 4 % 4, i % 4])      # (3, S)
        off = rng.integers(0, 5, (3, B, 1))
        out["positions"] = (grid[:, None, :] + off).astype(np.int32)
    return out


# ===========================================================================
# Configs and parameters
# ===========================================================================
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", NEW)
def test_config_copy_matches_reference(name, smoke):
    ours, ref = ARCHS[name], JAX_ARCHS[name]
    if smoke:
        ours, ref = smoke_config(ours), jax_smoke(ref)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert ours.is_encoder_only == ref.is_encoder_only
    assert ours.subquadratic == ref.subquadratic
    assert ours.attention_free == ref.attention_free
    for shape in SHAPES:
        assert shape_skip_reason(ours, SHAPES[shape]) == \
            jskip(ref, JSHAPES[shape])
    assert get_arch(name.replace("-", "_")) is ARCHS[name]


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", NEW)
def test_param_defs_match_reference_shapes(name, full):
    cfg, jcfg = ARCHS[name], JAX_ARCHS[name]
    if not full:
        cfg, jcfg = smoke_config(cfg), jax_smoke(jcfg)
    ours = param_defs(cfg)
    assert _shapes(ours) == _shapes(jdefs(jcfg))
    blocks = ours["blocks"]
    assert ("wg" in blocks) == (cfg.mlp == "swiglu")
    for leaf in ("ln1", "ln2"):
        assert ("bias" in blocks[leaf]) == (cfg.norm == "layernorm")
    assert ("q_norm" in blocks) == cfg.qk_norm


@pytest.mark.parametrize("name", NEW)
def test_params_cross_from_the_reference(name):
    """Every leaf, LayerNorm's ``bias`` and the GELU MLP's included,
    arrives as the reference drew it; a bf16 runtime keeps the norm
    leaves (bias too) in f32, as the reference reads them."""
    cfg, _, jp, tp = _model(name)
    for path, leaf in tree_items(tp):
        want = jp
        for k in path:
            want = want[k]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want))
    cast = cast_params(tp, _rt("bfloat16"))
    assert cast["blocks"]["wq"].dtype == torch.bfloat16
    for leaf in ("ln1", "ln2"):
        for p in cast["blocks"][leaf].values():
            assert p.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in cast["final_norm"].values())


# ===========================================================================
# The model with reference weights
# ===========================================================================
@pytest.mark.parametrize("impl", sorted(TPOL))
@pytest.mark.parametrize("name", NEW)
def test_forward_logits_match_reference(name, impl):
    cfg, jcfg, jp, tp = _model(name)
    batch = _batch(cfg, 2, 40)
    want, _ = jforward(jp, jcfg, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, _jrt())
    got, aux = forward(tp, cfg, {k: torch.from_numpy(v) for k, v in
                                 batch.items()}, _rt(kernels=TPOL[impl]))
    assert got.shape == (2, 40, cfg.vocab_size) and float(aux) == 0.0
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                               **F32_TOL)


def test_mrope_sections_take_their_own_components():
    """qwen2-vl's logits depend on every position component: moving the
    height and width components alone changes them. Three identical
    components give standard RoPE, which a model without M-RoPE computes
    from component 0 of the same (3, B, S) positions."""
    cfg, _, _, tp = _model("qwen2-vl-7b")
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, 2, 24).items()}
    rt = _rt()
    base, _ = forward(tp, cfg, b, rt)
    moved = dict(b, positions=b["positions"] + torch.tensor(
        [0, 3, 5], dtype=torch.int32)[:, None, None])
    assert not torch.allclose(forward(tp, cfg, moved, rt)[0], base)
    same = dict(b, positions=b["positions"][:1].expand(3, -1, -1))
    standard = cfg.replace(rope="standard", mrope_sections=())
    torch.testing.assert_close(forward(tp, cfg, same, rt)[0],
                               forward(tp, standard, same, rt)[0])


def _greedy(name, rt, jrt, steps=8, B=3, S=21, seed=1):
    """Prefill then greedy decode steps on both sides: the tokens must be
    identical and each step's logits within LOGIT_RTOL. Returns the
    port's and the reference's caches."""
    cfg, jcfg, jp, tp = _model(name)
    toks = _tokens(cfg, B, S, seed=seed)
    jcache, jlog = jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                            MAX_LEN, jrt)
    cache, log = prefill(tp, cfg, {"tokens": torch.from_numpy(toks)},
                         MAX_LEN, rt)
    assert _rel_err(log.numpy(), jlog) < LOGIT_RTOL
    jstep = jax.jit(lambda c, t: jdecode(jp, jcfg, c, t, jrt))
    jt, tt = jnp.argmax(jlog, -1).astype(jnp.int32), log.argmax(-1)
    for _ in range(steps):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jcache, jlog = jstep(jcache, jt)
        cache, log = decode_step(tp, cfg, cache, tt, rt)
        assert _rel_err(log.numpy(), jlog) < LOGIT_RTOL
        jt, tt = jnp.argmax(jlog, -1).astype(jnp.int32), log.argmax(-1)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    return cache, jcache


@pytest.mark.parametrize("impl", sorted(TPOL))
@pytest.mark.parametrize("name", DECODERS)
def test_prefill_and_greedy_decode_match_reference(name, impl):
    cache, jcache = _greedy(name, _rt(kernels=TPOL[impl]), _jrt())
    assert set(cache) == set(jcache) == {"pos", "k", "v"}
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jcache[n]),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", DECODERS)
def test_int8_kv_matches_reference_int8_path(name):
    cache, jcache = _greedy(name, _rt(kv_dtype="int8"),
                            _jrt(kv_dtype="int8"))
    assert set(cache) == {"pos", "k", "v", "ks", "vs"}
    assert cache["k"].dtype == torch.int8
    assert tuple(cache["ks"].shape) == tuple(jcache["ks"].shape)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
@pytest.mark.parametrize("name", DECODERS)
def test_decode_step_paged_equals_decode_step(name, kv_dtype):
    """The prefill's rows written into scattered pages: every paged step
    gives the contiguous step's logits bit for bit."""
    cfg, _, _, tp = _model(name)
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
    paged["pos"].copy_(cache["pos"])
    tok = log.argmax(-1)
    for _ in range(5):
        cache, log = decode_step(tp, cfg, cache, tok, rt)
        paged, plog = decode_step_paged(tp, cfg, paged, tok, rt,
                                        page_size=ps, window=MAX_LEN)
        assert torch.equal(plog, log)
        tok = log.argmax(-1)


# ===========================================================================
# Serving
# ===========================================================================
TRACE = [(3, 5), (8, 4), (5, 6), (12, 3), (17, 5), (9, 4)]


def _streams(eng, mk, reqs):
    for i, (p, new) in enumerate(reqs):
        eng.submit(mk(rid=i, prompt=p, max_new_tokens=new))
    eng.run()
    return {r.rid: list(r.out_tokens) for r in eng.finished}


@pytest.mark.parametrize("name", DECODERS)
def test_engines_match_reference_engines(name):
    """Both port engines serve the reference engines' token streams (f32,
    greedy, padded buckets with the prefix cache on)."""
    cfg, jcfg, jp, tp = _model(name)
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), new)
            for n, new in TRACE]
    want = _streams(JServe(jp, jcfg, _jrt(), n_slots=3, max_len=MAX_LEN),
                    JRequest, reqs)
    assert want == _streams(JPaged(jp, jcfg, _jrt(), n_slots=3,
                                   max_len=MAX_LEN, page_size=8),
                            JRequest, reqs)
    for eng in (ServeEngine(tp, cfg, _rt(), n_slots=3, max_len=MAX_LEN),
                PagedServeEngine(tp, cfg, _rt(), n_slots=3, max_len=MAX_LEN,
                                 page_size=8)):
        assert _streams(eng, Request, reqs) == want


def test_hubert_is_refused_by_the_engine_and_the_launcher():
    cfg, _, _, tp = _model("hubert-xlarge")
    assert cfg.is_encoder_only
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(tp, cfg, _rt(), n_slots=2, max_len=MAX_LEN)
    with pytest.raises(SystemExit, match="encoder-only"):
        serve_launcher.main(["--arch", "hubert-xlarge", "--smoke",
                             "--device", "cpu"])


@pytest.mark.parametrize("name", ["stablelm-12b", "qwen2-vl-7b"])
def test_serve_launcher_serves_on_cpu(capsys, name):
    serve_launcher.main(["--arch", name, "--smoke", "--device", "cpu",
                         "--requests", "3", "--max-new", "4", "--max-len",
                         "32", "--page-size", "8", "--kv-dtype", "int8"])
    assert "served 3/3 requests, 12 tokens" in capsys.readouterr().out


# ===========================================================================
# LayerNorm and GELU
# ===========================================================================
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((5, 7, 160)) * 3 + 1).astype(np.float32)
    s, b = (rng.standard_normal(160).astype(np.float32) for _ in range(2))
    want = jlayernorm(jnp.asarray(x).astype(dtype), jnp.asarray(s),
                      jnp.asarray(b))
    got = layernorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                    torch.from_numpy(s), torch.from_numpy(b))
    assert str(got.dtype) == f"torch.{dtype}"
    tol = OP_TOL if dtype == "float32" else dict(atol=0, rtol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


def test_gelu_is_the_tanh_approximation():
    """``jax.nn.gelu`` defaults to the tanh form; the port matches it to
    f32 rounding, and the exact erf form (``F.gelu``'s default) fails the
    same bar."""
    x = np.linspace(-4, 4, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **OP_TOL)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert not np.allclose(erf, want, **OP_TOL)


# ===========================================================================
# The decode ops' plain versions at large groups and head dim 160
# ===========================================================================
OP_CASES = [  # B, Hq, Hkv, D, ps, NP, W
    (2, 32, 2, 16, 8, 5, 37),      # G 16 (chatglm3-6b's group)
    (3, 24, 2, 16, 4, 9, 33),      # G 12 (starcoder2-3b's group)
    (2, 8, 2, 160, 8, 4, 29),      # D 160, G 4 (stablelm-12b's)
    (2, 16, 1, 160, 4, 3, 12),     # D 160, G 16
]


def _op_inputs(B, Hq, Hkv, Dh, ps, NP, W, seed=0):
    rng = np.random.default_rng(seed)
    P = B * NP + 1
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, W, Hkv, Dh)).astype(np.float32)
              for _ in range(2))
    kp, vp = (rng.standard_normal((P, ps, Hkv, Dh)).astype(np.float32)
              for _ in range(2))
    pt = (rng.permutation(P - 1)[: B * NP] + 1).reshape(B, NP) \
        .astype(np.int32)
    pos = np.minimum(rng.integers(1, W, B), NP * ps - 1)
    mask = np.arange(W)[None, :] <= pos[:, None]
    ar = np.arange(NP * ps)[None, :]
    pmask = (ar <= pos[:, None]) & (ar < W)
    return q, kc, vc, kp, vp, pt, mask, pmask


def _int8(rng, shape):
    """int8 payloads and bf16-exact scales (multiples of 2^-10)."""
    return (rng.integers(-127, 128, shape).astype(np.int8),
            (rng.integers(1, 64, shape[:-1]) / 1024).astype(np.float32))


def _both(op, jargs, targs):
    want = jdispatch(op, XLA_POLICY, *jargs)
    got = D.dispatch(op, D.TORCH_POLICY, *targs)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               **OP_TOL)
    torch.testing.assert_close(D.dispatch(op, D.CUDA_POLICY, *targs), got)


@pytest.mark.parametrize("B,Hq,Hkv,Dh,ps,NP,W", OP_CASES)
def test_decode_plain_versions_match_reference(B, Hq, Hkv, Dh, ps, NP, W):
    q, kc, vc, kp, vp, pt, mask, pmask = _op_inputs(B, Hq, Hkv, Dh, ps,
                                                    NP, W)
    t = torch.from_numpy
    _both("decode_attention", tuple(map(jnp.asarray, (q, kc, vc, mask))),
          tuple(map(t, (q, kc, vc, mask))))
    _both("paged_decode_attention",
          tuple(map(jnp.asarray, (q, kp, vp, pt, pmask))),
          tuple(map(t, (q, kp, vp, pt, pmask))))
    rng = np.random.default_rng(1)
    (kq, ks), (vq, vs) = (_int8(rng, (B, W, Hkv, Dh)) for _ in range(2))
    (kpq, kps), (vpq, vps) = (_int8(rng, kp.shape) for _ in range(2))

    def jb(x):
        return jnp.asarray(x).astype(jnp.bfloat16)

    def tb(x):
        return torch.from_numpy(x).to(torch.bfloat16)

    _both("quant_decode_attention",
          (jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jb(ks), jb(vs),
           jnp.asarray(mask)),
          (t(q), t(kq), t(vq), tb(ks), tb(vs), t(mask)))
    _both("quant_paged_decode_attention",
          (jnp.asarray(q), jnp.asarray(kpq), jnp.asarray(vpq), jb(kps),
           jb(vps), jnp.asarray(pt), jnp.asarray(pmask)),
          (t(q), t(kpq), t(vpq), tb(kps), tb(vps), t(pt), t(pmask)))


# ===========================================================================
# Training
# ===========================================================================
@pytest.mark.parametrize("name", ["starcoder2-3b", "qwen2-vl-7b"])
def test_loss_and_grads_match_jax_grad(name):
    cfg, jcfg, jp, tp = _model(name)
    batch = _batch(cfg, 2, 16, seed=5)
    batch["labels"] = _tokens(cfg, 2, 16, seed=6)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss(p, jcfg, b, _jrt()), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, _, grads = value_and_grad(
        cfg, _rt(kernels=D.CUDA_POLICY, remat="none"), tp,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    want = dict(tree_items(jax.tree.map(np.asarray, jg)))
    got = dict(tree_items(grads))
    assert got.keys() == want.keys()
    for path, w in want.items():
        d = float(np.max(np.abs(got[path].numpy() - w)))
        assert d <= GRAD_RTOL * float(np.max(np.abs(w))), (path, d)


# ===========================================================================
# The trace front-end against the JAX trace
# ===========================================================================
def _groups(wl):
    """{(K, N): (count, flops, weight_bytes)} of the matmuls."""
    out = {}
    for o in wl.ops:
        if o.kind == "matmul":
            m = re.match(r"\w+\.(\d+)x(\d+)(?:\(x(\d+)\))?$", o.name)
            out[int(m[1]), int(m[2])] = (int(m[3] or 1), o.flops,
                                         o.weight_bytes)
    return out


TRACE_CASES = [(n, k) for n in ("chatglm3-6b", "stablelm-12b", "qwen2-vl-7b",
                                "hubert-xlarge")
               for k in ("train", "prefill", "decode")
               if not (k == "decode" and n == "hubert-xlarge")]


@pytest.mark.parametrize("name,kind", TRACE_CASES)
def test_trace_matches_jax_per_matmul_group(name, kind):
    """Each (K, N) group: the same FLOPs and weight bytes, the port's
    count the reference's (a layer scan's body, once) times the layers
    (the unembedding once); attention FLOPs equal."""
    cfg, jcfg = smoke_config(ARCHS[name]), jax_smoke(JAX_ARCHS[name])
    kv = 128 if kind == "decode" else None
    ref = jtrace(jcfg, JShape("t", 64, 2, kind, kv_len=kv))
    got = trace_workload(cfg, ShapeConfig("t", 64, 2, kind, kv_len=kv))
    r, g = _groups(ref), _groups(got)
    assert set(r) == set(g)
    for key, (rc, rf, rw) in r.items():
        trips = 1 if key == (cfg.d_model, cfg.vocab_size) else cfg.n_layers
        assert g[key] == (rc * trips, pytest.approx(rf, rel=1e-9),
                          pytest.approx(rw, rel=1e-9)), key
    att = [sum(o.flops for o in w.ops if o.kind == "attention")
           for w in (ref, got)]
    assert att[1] == pytest.approx(att[0], rel=1e-9)
    assert got.meta["pass"] == ref.meta["pass"]
