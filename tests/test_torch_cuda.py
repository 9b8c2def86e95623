"""Hand-written CUDA kernels against their plain versions, on the card.

Marked ``cuda``: skipped (with the reason) on a host without an NVIDIA
GPU. On the card: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``. f32 comparisons run with TF32 off, so the
plain versions' matmuls are full f32; tolerances are 1e-5 (summation
order only) in f32 and 2 bf16 ulps (2^-7 relative) in bf16, where both
sides round the f32 result once but may land on neighbouring values.
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA unavailable on this host)")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _tol(dtype):
    return (dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32
            else dict(atol=2e-2, rtol=2 ** -7))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(7, 16), (33, 2304), (4, 5000)])
def test_rmsnorm_kernel(dev, dtype, rows, d):
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(rows, d, device=dev, generator=g).to(dtype)
    s = torch.randn(d, device=dev, generator=g)
    n = rmsnorm.launches
    got = rmsnorm(x, s, eps=1e-5)
    assert rmsnorm.launches == n + 1
    torch.testing.assert_close(got.float(), rmsnorm_plain(x, s, eps=1e-5)
                               .float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window", [
    (2, 100, 4, 2, 16, True, 0), (1, 129, 4, 4, 64, True, 0),
    (1, 77, 8, 2, 128, True, 16), (2, 50, 2, 1, 32, False, 0)])
def test_flash_kernel(dev, dtype, B, S, Hq, Hkv, D, causal, window):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(B, S, Hq, D, device=dev, generator=g).to(dtype)
    k = torch.randn(B, S, Hkv, D, device=dev, generator=g).to(dtype)
    v = torch.randn(B, S, Hkv, D, device=dev, generator=g).to(dtype)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,D,W", [(3, 4, 2, 16, 50),
                                          (4, 36, 36, 64, 1024),
                                          (2, 16, 2, 128, 300)])
def test_decode_kernel(dev, dtype, B, Hq, Hkv, D, W):
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn(B, Hq, D, device=dev, generator=g).to(dtype)
    kc = torch.randn(B, W, Hkv, D, device=dev, generator=g).to(dtype)
    vc = torch.randn(B, W, Hkv, D, device=dev, generator=g).to(dtype)
    pos = torch.randint(0, W, (B, 1), device=dev, generator=g)
    mask = torch.arange(W, device=dev)[None, :] <= pos
    got = decode_attention(q, kc, vc, mask)
    want = decode_attention_plain(q, kc, vc, mask)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_wrappers_reject_bad_inputs(dev):
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.rmsnorm import rmsnorm
    x = torch.randn(4, 8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(x.t(), torch.ones(4, device=dev))
    with pytest.raises(TypeError, match="not supported"):
        rmsnorm(x.half(), torch.ones(8, device=dev))
    q = torch.randn(1, 2, 24, device=dev)
    kc = torch.randn(1, 8, 2, 24, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention(q, kc, kc, torch.ones(1, 8, dtype=torch.bool,
                                               device=dev))
