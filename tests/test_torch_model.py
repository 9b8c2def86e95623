"""Port model against the reference on smoke ``minicpm-2b``, on the CPU.

Weights are drawn once by the reference (``init_params(PRNGKey(0))``)
and handed to the port as numpy through ``params_from_numpy``, so both
packages compute the same function. f32 logits agree within 1e-4
relative to the largest logit (two frameworks' matmuls and
transcendentals, summed in different orders); greedy tokens are
identical and cache leaves agree to 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import ckpt as jckpt  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import decode_step as jdecode  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.models import prefill as jprefill  # noqa: E402
from repro.models.model import ModelRuntime as JRuntime  # noqa: E402
from repro.models.model import param_defs as jdefs  # noqa: E402

from repro_torch.configs import ARCHS, get_arch, smoke_config  # noqa: E402
from repro_torch.kernels.dispatch import KernelPolicy  # noqa: E402
from repro_torch.models import (ModelRuntime, cache_spec,  # noqa: E402
                                cast_params, decode_step, forward,
                                init_params, load_checkpoint, param_defs,
                                params_from_numpy, prefill)

ARCH = "minicpm-2b"
CFG = smoke_config(ARCHS[ARCH])
JCFG = jax_smoke(JAX_ARCHS[ARCH])
JRT = JRuntime(dtype="float32", remat="none", attn_chunk=8)
RTS = {"torch": ModelRuntime(dtype="float32", attn_chunk=8, device="cpu",
                             kernels=KernelPolicy.torch()),
       "cuda": ModelRuntime(dtype="float32", attn_chunk=8, device="cpu")}
LOGIT_RTOL = 1e-4


@pytest.fixture(scope="module")
def jparams():
    return jinit(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def tparams(jparams):
    tree = jax.tree.map(np.asarray, jparams)
    return params_from_numpy(CFG, tree, device="cpu")


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG.vocab_size, (B, S)).astype(np.int32)


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))
                 / np.max(np.abs(want)))


# ===========================================================================
# Configs and parameter layout
# ===========================================================================
@pytest.mark.parametrize("smoke", [False, True])
def test_config_copy_matches_reference(smoke):
    ours, ref = ARCHS[ARCH], JAX_ARCHS[ARCH]
    if smoke:
        ours, ref = smoke_config(ours), jax_smoke(ref)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.param_count() == ref.param_count()
    assert get_arch("minicpm_2b") is ARCHS[ARCH]


def test_unported_arch_names_roadmap():
    """No arch of the reference is left unported: the port registers
    exactly the reference's ten, in its order, each config equal to the
    reference's; an unknown name raises and lists them."""
    assert list(ARCHS) == list(JAX_ARCHS) and len(ARCHS) == 10
    for name, ref in JAX_ARCHS.items():
        assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(ref)
        assert get_arch(name).param_count() == ref.param_count()
    with pytest.raises(KeyError, match="available"):
        get_arch("gpt-2")


@pytest.mark.parametrize("full", [False, True])
def test_param_defs_match_reference_shapes(full):
    cfg, jcfg = (ARCHS[ARCH], JAX_ARCHS[ARCH]) if full else (CFG, JCFG)
    ours = jax.tree.map(lambda d: tuple(d.shape), param_defs(cfg),
                        is_leaf=lambda x: hasattr(x, "init"))
    ref = jax.tree.map(lambda d: tuple(d.shape), jdefs(jcfg),
                       is_leaf=lambda x: hasattr(x, "init"))
    assert ours == ref


def test_init_params_seeded_distributions():
    p0 = init_params(CFG, seed=0, device="cpu")
    p1 = init_params(CFG, seed=0, device="cpu")
    p2 = init_params(CFG, seed=1, device="cpu")
    torch.testing.assert_close(p0["blocks"]["wq"], p1["blocks"]["wq"])
    assert not torch.equal(p0["blocks"]["wq"], p2["blocks"]["wq"])
    assert not torch.equal(p0["blocks"]["wq"], p0["blocks"]["wk"])
    assert torch.equal(p0["blocks"]["ln1"]["scale"],
                       torch.ones(CFG.n_layers, CFG.d_model))
    std = 1.0 / np.sqrt(CFG.d_model)
    wq = p0["blocks"]["wq"]
    assert float(wq.abs().max()) <= 2 * std + 1e-6          # truncated
    assert abs(float(wq.std()) / std - 0.88) < 0.06      # trunc-normal std
    assert abs(float(p0["embed"].std()) - 0.02) < 0.002


def test_params_from_numpy_rejects_bad_trees(jparams):
    tree = jax.tree.map(np.asarray, jparams)
    bad = dict(tree, embed=tree["embed"][:, :8])
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(CFG, bad, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(CFG, missing, device="cpu")


def test_load_checkpoint_round_trip(jparams, tmp_path):
    path = jckpt.save(str(tmp_path), 3, jparams)
    tree = load_checkpoint(path)
    want = jax.tree.map(np.asarray, jparams)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    params = params_from_numpy(CFG, tree, device="cpu")
    np.testing.assert_array_equal(params["blocks"]["wo2"].numpy(),
                                  want["blocks"]["wo2"])
    (tmp_path / "step_00000003" / "_COMPLETE").unlink()
    with pytest.raises(FileNotFoundError):
        load_checkpoint(path)


def test_cast_params_keeps_norms_f32(tparams):
    rt = ModelRuntime(dtype="bfloat16", device="cpu")
    cast = cast_params(tparams, rt)
    assert cast["blocks"]["wq"].dtype == torch.bfloat16
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["blocks"]["ln1"]["scale"].dtype == torch.float32
    assert cast["final_norm"]["scale"].dtype == torch.float32
    same = cast_params(tparams, RTS["torch"])         # f32 -> f32: no copy
    assert same["blocks"]["wq"] is tparams["blocks"]["wq"]


# ===========================================================================
# Forward / prefill / decode parity
# ===========================================================================
@pytest.mark.parametrize("impl", sorted(RTS))
def test_forward_logits_match_reference(jparams, tparams, impl):
    toks = _tokens(2, 19)
    want, _ = jforward(jparams, JCFG, {"tokens": jnp.asarray(toks)}, JRT)
    got, aux = forward(tparams, CFG, {"tokens": torch.from_numpy(toks)},
                       RTS[impl])
    assert got.shape == (2, 19, CFG.vocab_size) and float(aux) == 0.0
    assert _rel_err(got.numpy(), want) < LOGIT_RTOL


@pytest.mark.parametrize("impl", sorted(RTS))
def test_prefill_and_greedy_decode_match_reference(jparams, tparams, impl):
    """Right-padded prefill with ``lengths=`` then greedy decode steps:
    tokens identical, logits and cache leaves within tolerance."""
    rt = RTS[impl]
    max_len, S, steps = 48, 16, 6
    toks = _tokens(3, S, seed=1)
    lengths = np.array([16, 9, 3], np.int32)
    for j, n in enumerate(lengths):
        toks[j, n:] = 0                                 # right padding
    jcache, jlog = jprefill(jparams, JCFG, {"tokens": jnp.asarray(toks)},
                            max_len, JRT, lengths=jnp.asarray(lengths))
    cache, log = prefill(tparams, CFG, {"tokens": torch.from_numpy(toks)},
                         max_len, rt, lengths=torch.from_numpy(lengths))
    assert set(cache) == set(jcache) == set(cache_spec(CFG, 3, max_len))
    for name in cache:
        assert tuple(cache[name].shape) == tuple(jcache[name].shape)
    np.testing.assert_array_equal(cache["pos"].numpy(), lengths)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=1e-5,
                                   rtol=1e-5)
    assert _rel_err(log.numpy(), jlog) < LOGIT_RTOL
    jt = jnp.argmax(jlog, -1).astype(jnp.int32)
    tt = log.argmax(-1)
    for _ in range(steps):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        jcache, jlog = jdecode(jparams, JCFG, jcache, jt, JRT)
        cache, log = decode_step(tparams, CFG, cache, tt, rt)
        assert _rel_err(log.numpy(), jlog) < LOGIT_RTOL
        jt = jnp.argmax(jlog, -1).astype(jnp.int32)
        tt = log.argmax(-1)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(jcache[name]), atol=1e-5,
                                   rtol=1e-5)


def test_model_hands_kernels_contiguous_inputs(tparams, monkeypatch):
    """The CUDA wrappers raise on non-contiguous inputs; on the CPU they
    take the plain path, so check here that every call the model makes
    through the ``cuda`` impls would be accepted on the card."""
    from repro_torch.kernels import dispatch as D
    seen = []
    for op in ("rmsnorm", "prefill_attention", "decode_attention"):
        impl = D.implementations(op)["cuda"]

        def checked(*arrays, _impl=impl, _op=op, **kw):
            for a in arrays:
                assert a.is_contiguous(), (_op, tuple(a.shape), a.stride())
            seen.append(_op)
            return _impl(*arrays, **kw)

        monkeypatch.setitem(D.implementations(op), "cuda", checked)
    rt = RTS["cuda"]
    toks = torch.from_numpy(_tokens(3, 10))
    forward(tparams, CFG, {"tokens": toks}, rt)
    for lengths in (None, torch.tensor([10, 4, 7], dtype=torch.int32)):
        cache, log = prefill(tparams, CFG, {"tokens": toks}, 24, rt,
                             lengths=lengths)
        decode_step(tparams, CFG, cache, log.argmax(-1), rt)
    assert set(seen) == {"rmsnorm", "prefill_attention", "decode_attention"}


def test_prefill_longer_than_window_keeps_last_rows(tparams):
    """_fill_kv_window: with S > W the key at position p lands in slot
    p % W, exactly as decoding the same tokens one by one would place
    it (the slot arithmetic of decode_step)."""
    from repro_torch.models.model import _fill_kv_window
    B, S, W = 2, 11, 4
    k = torch.arange(B * S, dtype=torch.float32).reshape(B, S, 1, 1)
    out = torch.zeros(B, W, 1, 1)
    _fill_kv_window(out, k)
    for p in range(S - W, S):
        torch.testing.assert_close(out[:, p % W], k[:, p])


def test_entry_points_need_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the no-card path cannot run")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        cast_params({"embed": torch.zeros(2, 2)}, ModelRuntime())
