"""Hand-written CUDA kernels against their plain versions, on the card.

Covers rmsnorm, flash prefill and the four split-KV decode variants
(contiguous, paged, int8, int8 paged) at odd shapes: page sizes 8 and
16, page counts that are not a split multiple, G 1-8, D 16-128, a
window that is not a page multiple, a table row all at the null page;
the grouped expert GEMM (ragged f, empty experts, trailing blocks) and
the chunked SSD scan (ragged chunks, S < chunk) and the int8-weight
matmul (ragged T, K and N, both tile shapes, an unaligned weight).

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


# ---------------------------------------------------------------- paged
def _paged_inputs(dev, g, B, Hq, Hkv, D, ps, NP, W, dtype, quant):
    """Pool of B * NP + 1 pages, a scattered table (sequence 0's row all
    null page: a retired slot), ragged positions and the paged mask
    ``(ar <= pos) & (ar < W)``."""
    from repro_torch.kernels.quant import quantize_rows
    P = B * NP + 1
    q = torch.randn(B, Hq, D, device=dev, generator=g).to(dtype)
    pages = [torch.randn(P, ps, Hkv, D, device=dev, generator=g)
             for _ in range(2)]
    if quant:
        pages = [t for pg in pages for t in quantize_rows(pg)]
    else:
        pages = [pg.to(dtype) for pg in pages]
    perm = torch.randperm(P - 1, device=dev, generator=g)[: B * NP] + 1
    pt = perm.reshape(B, NP).to(torch.int32)
    pt[0] = 0
    pos = torch.randint(0, W, (B, 1), device=dev, generator=g)
    ar = torch.arange(NP * ps, device=dev)[None, :]
    return q, pages, pt, (ar <= pos) & (ar < W)


PAGED_CASES = [  # B, Hq, Hkv, D, ps, NP, W
    (3, 4, 2, 16, 8, 5, 37),      # ragged last page, G 2, D 16
    (2, 8, 1, 128, 16, 9, 144),   # NP * ps not a split multiple, G 8
    (4, 36, 36, 64, 16, 64, 1024),  # full width minicpm-2b, G 1
    (2, 3, 3, 32, 8, 17, 130),    # G 1, D 32
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,D,ps,NP,W", PAGED_CASES)
def test_paged_kernel(dev, dtype, B, Hq, Hkv, D, ps, NP, W):
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention, paged_decode_attention_plain)
    g = torch.Generator(device=dev).manual_seed(3)
    q, (kp, vp), pt, mask = _paged_inputs(dev, g, B, Hq, Hkv, D, ps, NP, W,
                                          dtype, quant=False)
    n = paged_decode_attention.launches
    got = paged_decode_attention(q, kp, vp, pt, mask)
    assert paged_decode_attention.launches == n + 1
    want = paged_decode_attention_plain(q, kp, vp, pt, mask)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,D,ps,NP,W", PAGED_CASES)
def test_quant_paged_kernel(dev, dtype, B, Hq, Hkv, D, ps, NP, W):
    from repro_torch.kernels.quant import (
        quant_paged_decode_attention, quant_paged_decode_attention_plain)
    g = torch.Generator(device=dev).manual_seed(4)
    q, (kp, ks, vp, vs), pt, mask = _paged_inputs(
        dev, g, B, Hq, Hkv, D, ps, NP, W, dtype, quant=True)
    n = quant_paged_decode_attention.launches
    got = quant_paged_decode_attention(q, kp, vp, ks, vs, pt, mask)
    assert quant_paged_decode_attention.launches == n + 1
    want = quant_paged_decode_attention_plain(q, kp, vp, ks, vs, pt, mask)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,D,W", [(3, 4, 2, 16, 50),
                                          (4, 36, 36, 64, 1024),
                                          (2, 16, 2, 128, 300),
                                          (2, 5, 5, 32, 129)])
def test_quant_kernel(dev, dtype, B, Hq, Hkv, D, W):
    from repro_torch.kernels.quant import (quant_decode_attention,
                                           quant_decode_attention_plain,
                                           quantize_rows)
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn(B, Hq, D, device=dev, generator=g).to(dtype)
    kq, ks = quantize_rows(torch.randn(B, W, Hkv, D, device=dev,
                                       generator=g))
    vq, vs = quantize_rows(torch.randn(B, W, Hkv, D, device=dev,
                                       generator=g))
    pos = torch.randint(0, W, (B, 1), device=dev, generator=g)
    mask = torch.arange(W, device=dev)[None, :] <= pos
    got = quant_decode_attention(q, kq, vq, ks, vs, mask)
    want = quant_decode_attention_plain(q, kq, vq, ks, vs, mask)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_paged_kernel_equals_contiguous_bit_for_bit(dev):
    """The same rows, paged or contiguous, give identical outputs: the
    split of logical rows and every sum are the same."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_attention import (gather_pages,
                                                     paged_decode_attention)
    from repro_torch.kernels.quant import (quant_decode_attention,
                                           quant_paged_decode_attention)
    g = torch.Generator(device=dev).manual_seed(6)
    args = (dev, g, 4, 36, 36, 64, 16, 64, 1024)
    q, (kp, vp), pt, mask = _paged_inputs(*args, torch.bfloat16, False)
    c = [gather_pages(t, pt).contiguous() for t in (kp, vp)]
    assert torch.equal(paged_decode_attention(q, kp, vp, pt, mask),
                       decode_attention(q, *c, mask))
    q, pq, pt, mask = _paged_inputs(*args, torch.bfloat16, True)
    c = [gather_pages(t, pt).contiguous() for t in pq]
    assert torch.equal(
        quant_paged_decode_attention(q, pq[0], pq[2], pq[1], pq[3], pt,
                                     mask),
        quant_decode_attention(q, c[0], c[2], c[1], c[3], mask))


def test_new_wrappers_reject_bad_inputs(dev):
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.quant import (quant_decode_attention,
                                           quant_paged_decode_attention,
                                           quantize_rows)
    g = torch.Generator(device=dev).manual_seed(7)
    q, (kp, vp), pt, mask = _paged_inputs(dev, g, 2, 4, 2, 16, 8, 3, 20,
                                          torch.float32, False)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q, kp, vp, pt.long(), mask)
    with pytest.raises(ValueError, match="bfloat16"):
        paged_decode_attention(q, kp.bfloat16(), vp, pt, mask)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention(q, kp, vp, pt.t().contiguous().t(), mask)
    q, (kq, ks, vq, vs), pt, mask = _paged_inputs(
        dev, g, 2, 4, 2, 16, 8, 3, 20, torch.bfloat16, True)
    with pytest.raises(ValueError, match="int8"):
        quant_paged_decode_attention(q, kq.float(), vq, ks, vs, pt, mask)
    with pytest.raises(ValueError, match="int32"):
        quant_paged_decode_attention(q, kq, vq, ks, vs, pt.long(), mask)
    kc, ksc = quantize_rows(torch.randn(2, 8, 2, 16, device=dev,
                                        generator=g))
    m8 = torch.ones(2, 8, dtype=torch.bool, device=dev)
    strided = kc.transpose(1, 2).contiguous().transpose(1, 2)
    assert strided.shape == kc.shape and not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        quant_decode_attention(q, strided, kc, ksc, ksc, m8)
    with pytest.raises(ValueError, match="bfloat16"):
        quant_decode_attention(q, kc, kc, ksc.float(), ksc, m8)


# ---------------------------------------------------------------- moe
def _moe_case(dev, g, T, d, f, E, dtype, empty=()):
    x = torch.randn(T, d, device=dev, generator=g).to(dtype)
    w = (torch.randn(E, d, f, device=dev, generator=g) / d ** 0.5).to(dtype)
    eor = torch.randint(0, E, (T,), device=dev, generator=g)
    for e in empty:                               # experts with no row
        eor[eor == e] = (e + 1) % E
    return x, w, eor.to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,f,E", [
    (16, 2048, 1408, 60),      # qwen2-moe decode rows, f not a 64 multiple
    (300, 64, 100, 5),         # tall blocks, ragged f
    (7, 48, 40, 3),            # d not a 64 multiple, one block per expert
    (512, 256, 2048, 8),       # mixtral-like f 2048
])
def test_moe_gemm_kernel(dev, dtype, T, d, f, E):
    from repro_torch.kernels.moe_gemm import (
        BLOCK_M, block_rows, grouped_gemm_padded,
        grouped_gemm_padded_plain, moe_gemm, moe_gemm_plain, sort_by_expert)
    g = torch.Generator(device=dev).manual_seed(8)
    x, w, eor = _moe_case(dev, g, T, d, f, E, dtype, empty=(1,))
    n = grouped_gemm_padded.launches
    got = moe_gemm(x, w, eor, n_experts=E)
    assert grouped_gemm_padded.launches == n + 1
    torch.testing.assert_close(got.float(), moe_gemm_plain(
        x, w, eor, n_experts=E).float(), **_tol(dtype))
    # the padded layout: real rows equal, trailing blocks hold no row
    xp, be, inv, Tp = sort_by_expert(x, eor, E, BLOCK_M)
    rows = block_rows(inv, Tp // BLOCK_M, BLOCK_M)
    assert bool((be == E).any()) and bool((rows[be == E] == 0).all())
    torch.testing.assert_close(
        grouped_gemm_padded(xp, w, be, rows)[inv].float(),
        grouped_gemm_padded_plain(xp, w, be, rows)[inv].float(),
        **_tol(dtype))


def test_moe_gemm_rows_do_not_depend_on_their_batch(dev):
    """A row's result is the same whether it is sorted alone or with
    others: paged and contiguous serving give one stream."""
    from repro_torch.kernels.moe_gemm import moe_gemm
    g = torch.Generator(device=dev).manual_seed(9)
    x, w, eor = _moe_case(dev, g, 64, 512, 300, 6, torch.bfloat16)
    full = moe_gemm(x, w, eor, n_experts=6)
    assert torch.equal(moe_gemm(x[:5], w, eor[:5], n_experts=6), full[:5])


# ---------------------------------------------------------------- ssd
#: f32 SSD scan: each output sums up to a chunk of products over a
#: 128-wide state, weighted by exp() of cumulative sums that the kernel
#: takes serially and ``torch.cumsum`` in a parallel scan.
SSD_F32_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,S,nh,hp,N,chunk", [
    (1, 1024, 64, 64, 128, 256),   # mamba2-1.3b prefill
    (2, 300, 4, 64, 128, 256),     # ragged last chunk
    (1, 16, 3, 32, 16, 256),       # S < chunk
    (2, 100, 2, 16, 8, 32),        # hp 16, small state
])
def test_ssd_scan_kernel(dev, dtype, b, S, nh, hp, N, chunk):
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(b, S, nh, hp, device=dev, generator=g).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(b, S, nh, device=dev, generator=g) - 2.0)
    A = -torch.exp(torch.randn(nh, device=dev, generator=g) * 0.5)
    B = torch.randn(b, S, nh, N, device=dev, generator=g).to(dtype)
    C = torch.randn(b, S, nh, N, device=dev, generator=g).to(dtype)
    n = ssd_scan.launches
    y, h = ssd_scan(x, dt, A, B, C, chunk=chunk)
    assert ssd_scan.launches == n + 1
    yw, hw = ssd_chunked(x, dt, A, B, C, chunk)
    assert y.dtype == dtype and h.dtype == torch.float32
    tol = _tol(dtype) if dtype == torch.bfloat16 else SSD_F32_TOL
    torch.testing.assert_close(y.float(), yw.float(), **tol)
    torch.testing.assert_close(h, hw, **SSD_F32_TOL)


def test_moe_and_ssd_wrappers_reject_bad_inputs(dev):
    from repro_torch.kernels.moe_gemm import grouped_gemm_padded
    from repro_torch.kernels.ssd_scan import ssd_scan
    x = torch.randn(32, 16, device=dev)
    w = torch.randn(2, 16, 8, device=dev)
    be = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="block height"):
        grouped_gemm_padded(x, w, be[:1].repeat(4), be.repeat(2))
    with pytest.raises(ValueError, match="int32"):
        grouped_gemm_padded(x, w, be.long(), be)
    with pytest.raises(ValueError, match="match"):
        grouped_gemm_padded(x, w.bfloat16(), be, be)
    xs = torch.randn(1, 8, 2, 24, device=dev)
    dt = torch.rand(1, 8, 2, device=dev)
    A = -torch.ones(2, device=dev)
    Bm = torch.randn(1, 8, 2, 4, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        ssd_scan(xs, dt, A, Bm, Bm)
    with pytest.raises(ValueError, match="float32"):
        ssd_scan(xs[..., :16].contiguous(), dt.double(), A, Bm, Bm)


# ---------------------------------------------------------- quant_matmul
def _qmm_case(dev, g, T, K, N, dtype, offset=0):
    """x scaled by 1/sqrt(K) so outputs are of order 1; column 0 of the
    weight is all zero (scale 0). ``offset`` shifts the int8 weight off
    a 16-byte boundary (the kernel's scalar-load path)."""
    from repro_torch.kernels.quant import quantize_channels
    x = (torch.randn(T, K, device=dev, generator=g) / K ** 0.5).to(dtype)
    w = torch.randn(K, N, device=dev, generator=g)
    w[:, 0] = 0.0
    w_q, scale = quantize_channels(w)
    if offset:
        buf = torch.empty(K * N + offset, dtype=torch.int8, device=dev)
        buf[offset:].copy_(w_q.reshape(-1))
        w_q = buf[offset:].view(K, N)
    return x, w_q, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,K,N,offset", [
    (1, 2304, 17280, 0),       # minicpm-2b decode, one sequence
    (4, 2304, 17280, 0),       # four slots
    (37, 2300, 1000, 0),       # ragged T, K and N (N % 16 != 0)
    (1024, 2048, 16896, 0),    # qwen2-moe shared-expert rows, prefill
    (16, 64, 100, 0),          # the decode tile's last row count
    (17, 96, 48, 1),           # the prefill tile; unaligned weight
])
def test_quant_matmul_kernel(dev, dtype, T, K, N, offset):
    from repro_torch.kernels.quant import quant_matmul, quant_matmul_plain
    g = torch.Generator(device=dev).manual_seed(11)
    x, w_q, scale = _qmm_case(dev, g, T, K, N, dtype, offset)
    n = quant_matmul.launches
    got = quant_matmul(x, w_q, scale)
    assert quant_matmul.launches == n + 1
    assert got.dtype == dtype and tuple(got.shape) == (T, N)
    want = quant_matmul_plain(x, w_q, scale)
    assert not bool(got[:, 0].any())           # the zero-scale column
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_quant_matmul_dispatch_and_rejects_bad_inputs(dev):
    from repro_torch.kernels import dispatch as D
    from repro_torch.kernels.quant import quant_matmul
    g = torch.Generator(device=dev).manual_seed(12)
    x, w_q, scale = _qmm_case(dev, g, 5, 64, 32, torch.float32)
    n = quant_matmul.launches
    got = D.dispatch("quant_matmul", D.CUDA_POLICY, x, w_q, scale)
    assert quant_matmul.launches == n + 1
    want = D.dispatch("quant_matmul", D.TORCH_POLICY, x, w_q, scale)
    assert quant_matmul.launches == n + 1
    torch.testing.assert_close(got, want, **_tol(torch.float32))
    with pytest.raises(ValueError, match="int8"):
        quant_matmul(x, w_q.float(), scale)
    with pytest.raises(ValueError, match="shape"):
        quant_matmul(x, w_q[:32], scale)
    with pytest.raises(ValueError, match="contiguous"):
        quant_matmul(x.t().contiguous().t(), w_q, scale)
    with pytest.raises(TypeError, match="dtype"):
        quant_matmul(x.half(), w_q, scale)
