"""Port kernels' plain versions against the reference, on the CPU.

Each plain PyTorch version (the one the CUDA wrapper runs for CPU
tensors, and the one the card's kernels are held against) is compared
with the reference's ``xla`` implementation AND its Pallas kernel in
interpret mode, on the same numpy inputs. f32 tolerances are 1e-5: the
two sides sum in different orders, nothing else differs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.dispatch import XLA_POLICY  # noqa: E402
from repro.kernels.dispatch import dispatch as jdispatch  # noqa: E402
from repro.models import attention as jattn  # noqa: E402

from repro_torch.kernels import dispatch as D  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ===========================================================================
# RMSNorm
# ===========================================================================
@pytest.mark.parametrize("shape", [(12, 32), (2, 5, 4, 16), (3, 2304)])
def test_rmsnorm_plain_matches_reference(shape):
    rng = np.random.default_rng(0)
    x, s = _rand(rng, shape), _rand(rng, shape[-1:])
    want_x = jdispatch("rmsnorm", XLA_POLICY, jnp.asarray(x), jnp.asarray(s))
    want_p = jops.rmsnorm(jnp.asarray(x), jnp.asarray(s), eps=1e-6)
    got = rmsnorm_plain(_t(x), _t(s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_p), **TOL)


def test_rmsnorm_eps_threads_through_dispatch():
    """As the reference's test_rmsnorm_eps_threads_through_dispatch: a
    large eps reaches whichever implementation runs."""
    rng = np.random.default_rng(1)
    x, s = _rand(rng, (12, 32), 0.01), _rand(rng, (32,))
    eps = 0.05
    want = np.asarray(jops.rmsnorm(jnp.asarray(x), jnp.asarray(s), eps=eps))
    for pol in (None, D.TORCH_POLICY, D.CUDA_POLICY):
        got = D.dispatch("rmsnorm", pol, _t(x), _t(s), eps=eps)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        default = D.dispatch("rmsnorm", pol, _t(x), _t(s))
        assert float((got - default).abs().max()) > 1e-3


def test_rmsnorm_bf16_rounds_like_reference():
    rng = np.random.default_rng(2)
    x, s = _rand(rng, (6, 64)), _rand(rng, (64,))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jdispatch("rmsnorm", XLA_POLICY, xb, jnp.asarray(s))
    got = rmsnorm_plain(_t(np.asarray(xb.astype(jnp.float32)))
                        .to(torch.bfloat16), _t(s))
    assert got.dtype == torch.bfloat16
    # one bf16 ulp (2^-8 relative) for the f32 sum-order difference
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -8, atol=1e-6)


# ===========================================================================
# Flash prefill attention
# ===========================================================================
FLASH_CASES = [
    # B, S, Hq, Hkv, D, causal, window
    (2, 40, 4, 2, 16, True, 0),      # G = 2, S not a tile multiple, D = 16
    (1, 37, 4, 2, 16, True, 8),      # sliding window
    (2, 24, 2, 2, 64, True, 0),      # G = 1, D = 64 (minicpm head dim)
    (1, 20, 4, 1, 32, False, 0),     # bidirectional, G = 4
]


@pytest.mark.parametrize("B,S,Hq,Hkv,Dh,causal,window", FLASH_CASES)
def test_flash_plain_matches_reference(B, S, Hq, Hkv, Dh, causal, window):
    rng = np.random.default_rng(3)
    q = _rand(rng, (B, S, Hq, Dh))
    k, v = _rand(rng, (B, S, Hkv, Dh)), _rand(rng, (B, S, Hkv, Dh))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_x = jattn.chunked_attention(jq, jk, jv, causal=causal,
                                     window=window, chunk=16)
    want_p = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  block_q=16, block_k=16)
    for chunk in (16, 512):
        got = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                    window=window, chunk=chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_x), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_p), **TOL)


def test_flash_wrapper_uses_plain_on_cpu():
    rng = np.random.default_rng(4)
    q = _t(_rand(rng, (1, 9, 4, 16)))
    k, v = _t(_rand(rng, (1, 9, 2, 16))), _t(_rand(rng, (1, 9, 2, 16)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before      # no kernel on the CPU
    torch.testing.assert_close(got, flash_attention_plain(q, k, v))


# ===========================================================================
# Split-KV decode attention
# ===========================================================================
DECODE_CASES = [
    # B, Hq, Hkv, D, W
    (3, 4, 2, 16, 50),       # G = 2 (minicpm smoke), W not a block multiple
    (2, 2, 2, 64, 130),      # G = 1, D = 64, two splits of the kernel
]


@pytest.mark.parametrize("B,Hq,Hkv,Dh,W", DECODE_CASES)
@pytest.mark.parametrize("holes", [False, True])
def test_decode_plain_matches_reference(B, Hq, Hkv, Dh, W, holes):
    rng = np.random.default_rng(5)
    q = _rand(rng, (B, Hq, Dh))
    kc, vc = _rand(rng, (B, W, Hkv, Dh)), _rand(rng, (B, W, Hkv, Dh))
    pos = rng.integers(0, W, B)
    mask = np.arange(W)[None, :] <= pos[:, None]       # partial mask
    if holes:
        mask &= rng.random((B, W)) < 0.7
        mask[:, 0] = True                               # never a full hole
    jq, jk, jv, jm = map(jnp.asarray, (q, kc, vc, mask))
    want_x = jattn.decode_attention(jq, jk, jv, jm)
    want_p = jops.decode_attention(jq, jk, jv, jm, block_k=16)
    got = decode_attention_plain(_t(q), _t(kc), _t(vc), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_x), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_p), **TOL)
    before = decode_attention.launches
    torch.testing.assert_close(
        decode_attention(_t(q), _t(kc), _t(vc), _t(mask)), got)
    assert decode_attention.launches == before


# ===========================================================================
# Dispatch seam
# ===========================================================================
def test_policy_defaults_to_cuda_and_mirrors_op_names():
    from repro.kernels.dispatch import KERNEL_OPS as JAX_OPS
    assert D.KERNEL_OPS == JAX_OPS
    pol = D.resolve_policy(None)
    for op in D.KERNEL_OPS:
        assert pol.impl_for(op) == "cuda"
        assert D.TORCH_POLICY.impl_for(op) == "torch"
        assert set(D.implementations(op)) == {"torch", "cuda"}
    assert D.KernelPolicy.from_flag(False) == D.TORCH_POLICY
    assert pol.describe() == " ".join(f"{op}=cuda" for op in D.KERNEL_OPS)
    with pytest.raises(KeyError):
        pol.impl_for("nope")


@pytest.mark.parametrize("pol", [D.TORCH_POLICY, D.CUDA_POLICY])
def test_policy_params_reach_the_impl_through_dispatch(monkeypatch, pol):
    """A policy's per-op params are merged over the call-site kwargs and
    reach whichever implementation runs, as the reference's dispatch
    merges them; params of another op do not."""
    seen = []
    impl = pol.impl_for("prefill_attention")
    real = D.implementations("prefill_attention")[impl]

    def spy(*arrays, **kw):
        seen.append(kw)
        return real(*arrays, **kw)

    monkeypatch.setitem(D.implementations("prefill_attention"), impl, spy)
    tuned = pol.with_params("prefill_attention", chunk=3) \
        .with_params("ssd_scan", chunk=64)
    assert tuned.params_for("prefill_attention") == {"chunk": 3}
    assert tuned.with_params("ssd_scan", chunk=64) == tuned
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 7, h, 16, generator=g) for h in (4, 2, 2))
    got = D.dispatch("prefill_attention", tuned, q, k, v, causal=True,
                     chunk=512)
    assert seen == [{"causal": True, "chunk": 3}]
    torch.testing.assert_close(got, flash_attention_plain(q, k, v, chunk=3))


def test_rmsnorm_wrapper_counts_no_launch_on_cpu():
    x, s = torch.randn(4, 16), torch.randn(16)
    before = rmsnorm.launches
    torch.testing.assert_close(rmsnorm(x, s, eps=1e-3),
                               rmsnorm_plain(x, s, eps=1e-3))
    assert rmsnorm.launches == before


@pytest.mark.parametrize("op,make", [
    ("rmsnorm", lambda g: (torch.randn(5, 16, generator=g),
                           torch.randn(16, generator=g))),
    ("prefill_attention", lambda g: (torch.randn(1, 7, 4, 16, generator=g),
                                     torch.randn(1, 7, 2, 16, generator=g),
                                     torch.randn(1, 7, 2, 16, generator=g))),
    ("decode_attention", lambda g: (torch.randn(2, 4, 16, generator=g),
                                    torch.randn(2, 9, 2, 16, generator=g),
                                    torch.randn(2, 9, 2, 16, generator=g),
                                    torch.arange(9)[None, :]
                                    <= torch.tensor([[3], [8]]))),
    ("paged_decode_attention",
     lambda g: (torch.randn(2, 4, 16, generator=g),
                torch.randn(5, 4, 2, 16, generator=g),
                torch.randn(5, 4, 2, 16, generator=g),
                torch.tensor([[3, 1, 0], [2, 4, 0]], dtype=torch.int32),
                torch.arange(12)[None, :] <= torch.tensor([[6], [9]]))),
    ("quant_decode_attention",
     lambda g: (torch.randn(2, 4, 16, generator=g),
                torch.randint(-127, 128, (2, 9, 2, 16), generator=g,
                              dtype=torch.int8),
                torch.randint(-127, 128, (2, 9, 2, 16), generator=g,
                              dtype=torch.int8),
                torch.rand(2, 9, 2, generator=g).to(torch.bfloat16),
                torch.rand(2, 9, 2, generator=g).to(torch.bfloat16),
                torch.arange(9)[None, :] <= torch.tensor([[3], [8]]))),
    ("quant_paged_decode_attention",
     lambda g: (torch.randn(2, 4, 16, generator=g),
                torch.randint(-127, 128, (5, 4, 2, 16), generator=g,
                              dtype=torch.int8),
                torch.randint(-127, 128, (5, 4, 2, 16), generator=g,
                              dtype=torch.int8),
                torch.rand(5, 4, 2, generator=g).to(torch.bfloat16),
                torch.rand(5, 4, 2, generator=g).to(torch.bfloat16),
                torch.tensor([[3, 1, 0], [2, 4, 0]], dtype=torch.int32),
                torch.arange(12)[None, :] <= torch.tensor([[6], [9]]))),
    ("quant_matmul",
     lambda g: (torch.randn(5, 16, generator=g),
                torch.randint(-127, 128, (16, 12), generator=g,
                              dtype=torch.int8),
                torch.rand(12, generator=g))),
])
def test_kernel_forward_reference_backward(op, make):
    """The cuda impl runs inside the autograd.Function whose backward is
    the torch impl's autograd: gradients equal the plain version's (for
    the int8 ops, the gradient of the query and the scales)."""
    grads = []
    for pol in (D.TORCH_POLICY, D.CUDA_POLICY):
        args = [a.clone().requires_grad_(a.is_floating_point())
                for a in make(torch.Generator().manual_seed(0))]
        out = D.dispatch(op, pol, *args)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)) \
            .sum().backward()
        grads.append([a.grad for a in args if a.is_floating_point()])
    for gt, gc in zip(*grads):
        torch.testing.assert_close(gc, gt)
