"""Hand-written CUDA kernels against their plain versions, on the card.

Covers rmsnorm (the served widths at every row count, bit for bit
against its plain version; a width no vector divides, a misaligned
slice), flash prefill and the four split-KV decode variants
(contiguous, paged, int8, int8 paged) at odd shapes: page sizes 8 and
16, page counts that are not a split multiple, G 1-8, D 16-128 and
zamba2-2.7b's 80, a window that is not a page multiple, a table row all
at the null page;
D 160 (stablelm-12b) and G 12 and 16 (starcoder2-3b, chatglm3-6b);
paged equal to contiguous bit for bit, and for both the bf16 and the
int8 pair whole splits without a valid row, a sequence's bits
independent of its batch and no register spill in the served (G 1,
bf16 or int8 KV) instantiations;
the grouped expert GEMM (ragged f, empty experts, trailing blocks; its
bf16 tensor-core body at every m16 slice boundary of a block, with an
expert's blocks paired, ragged and unaligned operands, and the served
widths; a row's bits independent of its batch; the MoE layer's one
sort equal to three sorts, bit for bit) and the chunked SSD scan
(ragged chunks, S < chunk, 16 chunks, N 8, 12 and 16, a bf16 rerun
equal bit for bit) and the int8-weight matmul (ragged T, K and
N, both bodies, an unaligned weight); and the graph lint's traced
decode step, whose kernel nodes are the launches of one eager step. The
tensor-core bodies (bf16
flash, the int8-weight matmul at T > 16) are also held to
``chip_smoke.py``'s bars, one bf16 ulp and f32 summation order.

Marked ``cuda``: skipped (with the reason) on a host without an NVIDIA
GPU. On the card: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``. f32 comparisons run with TF32 off, so the
plain versions' matmuls are full f32; tolerances are 1e-5 (summation
order only) in f32 and 2 bf16 ulps (2^-7 relative) in bf16, where both
sides round the f32 result once but may land on neighbouring values.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

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
@pytest.mark.parametrize("rows,d", [(7, 16), (33, 2304), (4, 5000),
                                    (5, 2303), (1, 2303)])
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
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 8, 16, 37, 600, 2048])
@pytest.mark.parametrize("d", [2048, 2304, 4096, 2560, 5120, 160, 3584])
def test_rmsnorm_equals_the_plain_version_bit_for_bit(dev, dtype, rows, d):
    """At the served widths, at every row count (PyTorch's reduction
    changes its threads a row with the rows), the kernel sums in the
    plain version's order and rounds where it rounds: bit equality. The
    order is that of the PyTorch release ``REDUCE_ORDER_TORCH`` names,
    which this test requires."""
    from repro_torch.kernels.rmsnorm import (REDUCE_ORDER_TORCH, rmsnorm,
                                             rmsnorm_plain)
    assert torch.__version__.startswith(REDUCE_ORDER_TORCH), (
        f"csrc/rmsnorm.cu copies torch {REDUCE_ORDER_TORCH}x's reduction "
        f"order; this is torch {torch.__version__}: re-derive it")
    g = torch.Generator(device=dev).manual_seed(rows * d)
    x = torch.randn(rows, d, device=dev, generator=g).to(dtype)
    s = torch.randn(d, device=dev, generator=g)
    assert torch.equal(rmsnorm(x, s), rmsnorm_plain(x, s))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_misaligned_slice(dev, dtype):
    """A contiguous view one element into its storage (not aligned for a
    vector load) loads its elements one by one and comes out bit for bit
    as the aligned copy does, within the bar of the plain version."""
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
    g = torch.Generator(device=dev).manual_seed(3)
    rows, d = 37, 2048
    base = torch.randn(rows * d + 1, device=dev, generator=g).to(dtype)
    x = base[1:].view(rows, d)
    assert x.is_contiguous() and x.data_ptr() % 16
    s = torch.randn(d, device=dev, generator=g)
    got = rmsnorm(x, s)
    torch.testing.assert_close(got.float(), rmsnorm_plain(x, s).float(),
                               **_tol(dtype))
    assert torch.equal(got, rmsnorm(x.clone(), s))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window", [
    (2, 100, 4, 2, 16, True, 0), (1, 129, 4, 4, 64, True, 0),
    (1, 77, 8, 2, 128, True, 16), (2, 50, 2, 1, 32, False, 0),
    (1, 200, 4, 4, 80, True, 0), (2, 70, 4, 2, 80, True, 24),
    (1, 200, 8, 2, 160, True, 0), (2, 90, 4, 1, 160, True, 24),
    (1, 77, 4, 4, 160, False, 0)])
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


#: chip_smoke.py's bf16 bar: both sides round one f32 value once, so
#: they may differ by one bf16 ulp (2^-7 of the value) and no more.
BF16_TOL = dict(atol=1e-5, rtol=2 ** -7)


def _flash_case(dev, g, B, S, Hq, Hkv, D, dtype=torch.bfloat16):
    return [torch.randn(B, S, h, D, device=dev, generator=g).to(dtype)
            for h in (Hq, Hkv, Hkv)]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window", [
    (1, 1, 2, 1, 64, True, 0),        # one row
    (2, 63, 4, 2, 16, True, 0),       # one key tile less a row, D 16
    (1, 64, 8, 1, 32, True, 0),       # one whole tile, G 8, D 32
    (2, 65, 4, 4, 128, True, 0),      # a tile and a row, G 1, D 128
    (1, 700, 8, 4, 64, True, 16),     # window 16, not a tile multiple
    (1, 1024, 16, 2, 128, True, 0),   # qwen2-moe's heads, G 8
    (2, 1024, 4, 2, 64, True, 0),     # minicpm-2b's D, B 2
    (2, 130, 4, 2, 64, False, 0),     # not causal: every tile masked at T
    (1, 300, 2, 2, 128, True, 40),    # window on the 4-warp block
    (1, 1024, 32, 8, 160, True, 0),   # stablelm-12b's heads, D 160, G 4
    (2, 65, 4, 1, 160, True, 0),      # a tile and a row, D 160, G 4
    (1, 300, 8, 2, 160, True, 40),    # D 160, window
    (2, 130, 4, 4, 160, False, 0),    # D 160, not causal
])
def test_flash_mma_kernel(dev, B, S, Hq, Hkv, D, causal, window):
    """The bf16 tensor-core body at ragged S, every head dim (D 160
    reloading Q's fragments each key tile), G 1-8."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator(device=dev).manual_seed(13)
    q, k, v = _flash_case(dev, g, B, S, Hq, Hkv, D)
    n = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == n + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               **_tol(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,causal,window,chunk", [
    (2, 300, 32, 32, True, 0, 512),    # zamba2-2.7b's parity prefill
    (1, 1024, 32, 32, True, 0, 512),   # two chunks, the second's rows
    (1, 512, 32, 32, True, 0, 512),    # a chunk-mode prompt floor
    (4, 64, 32, 32, True, 0, 512),     # n < 128: the unvectorized sum
    (1, 8, 32, 32, True, 0, 512),      # the smallest floor
    (1, 333, 32, 32, True, 0, 512),    # n % 4 != 0: unaligned sum rows
    (1, 1000, 32, 32, True, 0, 256),   # another chunk, a ragged last
    (2, 200, 8, 2, True, 0, 512),      # G 4
    (1, 700, 8, 8, True, 100, 512),    # a window across the chunks
    (2, 150, 4, 4, False, 0, 64),      # not causal, three chunks
    (1, 5, 1, 1, True, 0, 512),        # 5 rows of p: not bit for bit
])
def test_flash_d80_equals_the_plain_version_bit_for_bit(dev, dtype, B, S,
                                                        Hq, Hkv, causal,
                                                        window, chunk):
    """At head dim 80 (zamba2-2.7b) the kernel runs the plain version's
    chunked loop op for op: its output equals ``flash_attention_plain``'s
    at the same ``chunk`` bit for bit, whenever the plain version's
    softmax sum has 16 rows or more (B * Hq * S, every served prefill);
    below, where PyTorch sums a row with more than 32 threads, it holds
    the one-ulp bar."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator(device=dev).manual_seed(S + B)
    q, k, v = _flash_case(dev, g, B, S, Hq, Hkv, 80, dtype)
    n = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window,
                          chunk=chunk)
    assert flash_attention.launches == n + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 chunk=chunk)
    if B * Hq * S >= 16:
        assert torch.equal(got, want)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_flash_mma_kernel_within_one_ulp(dev):
    """At S 1024, D 64 the bf16 body stays within chip_smoke.py's bar,
    which P rounded once to bf16 would break (P enters P.V as hi + lo)."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator(device=dev).manual_seed(14)
    q, k, v = _flash_case(dev, g, 1, 1024, 8, 8, 64)
    n = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == n + 1
    torch.testing.assert_close(got.float(), flash_attention_plain(q, k, v)
                               .float(), **BF16_TOL)


def test_flash_unaligned_bf16_view(dev):
    """A bf16 view off a 16-byte boundary takes the CUDA-core body."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    g = torch.Generator(device=dev).manual_seed(15)
    q, k, v = _flash_case(dev, g, 1, 77, 4, 2, 64)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    buf[1:].copy_(q.reshape(-1))
    qv = buf[1:].view(q.shape)
    n = flash_attention.launches
    got = flash_attention(qv, k, v)
    assert flash_attention.launches == n + 1
    torch.testing.assert_close(got.float(), flash_attention_plain(q, k, v)
                               .float(), **_tol(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Hq,Hkv,D,W", [(3, 4, 2, 16, 50),
                                          (4, 36, 36, 64, 1024),
                                          (2, 16, 2, 128, 300),
                                          (4, 32, 32, 80, 1024),
                                          (3, 4, 2, 80, 50),
                                          (4, 32, 2, 128, 1024),
                                          (2, 24, 2, 128, 300),
                                          (4, 32, 8, 160, 1024),
                                          (3, 4, 4, 160, 50),
                                          (2, 16, 1, 160, 130)])
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
    (4, 32, 32, 80, 16, 64, 1024),  # full width zamba2-2.7b, G 1, D 80
    (3, 8, 2, 80, 8, 5, 37),      # D 80, G 4, ragged last page
    (4, 32, 2, 128, 16, 64, 1024),  # chatglm3-6b's heads, G 16
    (3, 24, 2, 128, 8, 5, 37),    # starcoder2-3b's heads, G 12
    (4, 32, 8, 160, 16, 64, 1024),  # stablelm-12b's heads, D 160, G 4
    (2, 4, 4, 160, 8, 9, 70),     # D 160, G 1
    (2, 10, 1, 160, 16, 9, 144),  # D 160, G 10: two blocks of 5
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
                                          (2, 5, 5, 32, 129),
                                          (4, 32, 32, 80, 1024),
                                          (2, 4, 2, 80, 130),
                                          (4, 32, 2, 128, 1024),
                                          (2, 24, 2, 128, 300),
                                          (4, 32, 8, 160, 1024),
                                          (3, 4, 4, 160, 50),
                                          (2, 16, 1, 160, 130)])
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


EQUAL_CASES = [  # B, Hq, Hkv, D, ps, NP, W
    (4, 36, 36, 64, 16, 64, 1024),    # full width minicpm-2b, G 1
    (2, 16, 2, 128, 16, 9, 144),      # D 128, G 8
    (3, 4, 4, 16, 8, 5, 37),          # D 16, ps 8, ragged last page
    (4, 16, 16, 128, 16, 64, 1024),   # qwen2-moe-a2.7b's heads
    (4, 32, 32, 80, 16, 64, 1024),    # zamba2-2.7b's heads, D 80
    (2, 8, 4, 80, 8, 9, 72),          # D 80, G 2
    (2, 8, 1, 80, 16, 9, 144),        # D 80, G 8
    (4, 32, 2, 128, 16, 64, 1024),    # chatglm3-6b's heads, G 16
    (4, 24, 2, 128, 16, 64, 1024),    # starcoder2-3b's heads, G 12
    (4, 32, 8, 160, 16, 64, 1024),    # stablelm-12b's heads, D 160
    (3, 4, 4, 160, 8, 5, 37),         # D 160, G 1, ragged last page
]


@pytest.mark.parametrize("B,Hq,Hkv,D,ps,NP,W", EQUAL_CASES)
def test_paged_kernel_equals_contiguous_bit_for_bit(dev, B, Hq, Hkv, D, ps,
                                                    NP, W):
    """The same rows, paged or contiguous, give identical outputs: the
    split of logical rows and every sum are the same."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_attention import (gather_pages,
                                                     paged_decode_attention)
    from repro_torch.kernels.quant import (quant_decode_attention,
                                           quant_paged_decode_attention)
    g = torch.Generator(device=dev).manual_seed(6)
    args = (dev, g, B, Hq, Hkv, D, ps, NP, W)
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


def _quant_cache(dev, g, B, Hq, Hkv, D, W, dtype):
    """q and an int8 contiguous cache with its scales."""
    from repro_torch.kernels.quant import quantize_rows
    q = torch.randn(B, Hq, D, device=dev, generator=g).to(dtype)
    kq, ks = quantize_rows(torch.randn(B, W, Hkv, D, device=dev,
                                       generator=g))
    vq, vs = quantize_rows(torch.randn(B, W, Hkv, D, device=dev,
                                       generator=g))
    return q, kq, vq, ks, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D", [(36, 36, 64), (16, 2, 128)])
def test_quant_kernels_fully_masked_splits(dev, dtype, Hq, Hkv, D):
    """Sequence 0's one valid row is row 0 of a 1,024-row window, so 7 of
    its 8 splits hold no valid row: they must weigh nothing, and the
    output is that row's V, dequantized, exactly (one weight of 1)."""
    from repro_torch.kernels.paged_attention import gather_pages
    from repro_torch.kernels.quant import (
        dequantize_rows, quant_decode_attention,
        quant_decode_attention_plain, quant_paged_decode_attention)
    g = torch.Generator(device=dev).manual_seed(8)
    B, W, ps = 2, 1024, 16
    NP = W // ps
    q, kq, vq, ks, vs = _quant_cache(dev, g, B, Hq, Hkv, D, W, dtype)
    mask = torch.arange(W, device=dev)[None, :] <= torch.tensor(
        [[0], [W - 1]], device=dev)
    got = quant_decode_attention(q, kq, vq, ks, vs, mask)
    torch.testing.assert_close(
        got.float(), quant_decode_attention_plain(q, kq, vq, ks, vs, mask)
        .float(), **_tol(dtype))
    row0 = dequantize_rows(vq[0, 0], vs[0, 0])            # (Hkv, D)
    want0 = row0.repeat_interleave(Hq // Hkv, dim=0).to(dtype)
    assert torch.equal(got[0], want0)
    # the same rows through a page table: pages in reverse order
    pt = torch.arange(B * NP, device=dev, dtype=torch.int32) \
        .flip(0).reshape(B, NP)
    pool = [torch.empty((B * NP, ps) + tuple(t.shape[2:]), dtype=t.dtype,
                        device=dev) for t in (kq, vq, ks, vs)]
    for p, t in zip(pool, (kq, vq, ks, vs)):
        p[pt.long()] = t.reshape((B, NP, ps) + tuple(t.shape[2:]))
        assert torch.equal(gather_pages(p, pt), t)
    assert torch.equal(quant_paged_decode_attention(q, *pool, pt, mask), got)


@pytest.mark.parametrize("Hq,Hkv,D", [(36, 36, 64), (16, 16, 128),
                                      (8, 1, 32), (32, 2, 128),
                                      (32, 8, 160)])
def test_quant_kernels_rows_do_not_depend_on_their_batch(dev, Hq, Hkv, D):
    """Each sequence alone gives the bits it gives inside a batch of 4,
    contiguous and paged."""
    from repro_torch.kernels.quant import (quant_decode_attention,
                                           quant_paged_decode_attention)
    g = torch.Generator(device=dev).manual_seed(9)
    B, W = 4, 1024
    q, kq, vq, ks, vs = _quant_cache(dev, g, B, Hq, Hkv, D, W,
                                     torch.bfloat16)
    mask = torch.arange(W, device=dev)[None, :] <= torch.tensor(
        [[1023], [700], [300], [12]], device=dev)
    batch = quant_decode_attention(q, kq, vq, ks, vs, mask)
    q2, (kp, ksp, vp, vsp), pt, _ = _paged_inputs(
        dev, g, B, Hq, Hkv, D, 16, 64, W, torch.bfloat16, True)
    pbatch = quant_paged_decode_attention(q2, kp, vp, ksp, vsp, pt, mask)
    for i in range(B):
        one = slice(i, i + 1)
        alone = quant_decode_attention(
            q[one].contiguous(), *(t[one].contiguous()
                                   for t in (kq, vq, ks, vs)),
            mask[one].contiguous())
        assert torch.equal(alone[0], batch[i])
        palone = quant_paged_decode_attention(
            q2[one].contiguous(), kp, vp, ksp, vsp, pt[one].contiguous(),
            mask[one].contiguous())
        assert torch.equal(palone[0], pbatch[i])


def _bf16_cache(dev, g, B, Hq, Hkv, D, W, dtype):
    """q and a float / bf16 contiguous cache."""
    return tuple(torch.randn(*shape, device=dev, generator=g).to(dtype)
                 for shape in ((B, Hq, D), (B, W, Hkv, D), (B, W, Hkv, D)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D", [(36, 36, 64), (16, 2, 128)])
def test_kernels_fully_masked_splits(dev, dtype, Hq, Hkv, D):
    """The bf16/f32 pair: sequence 0's one valid row is row 0 of a
    1,024-row window, so 7 of its 8 splits hold no valid row: they must
    weigh nothing, and the output is that row's V exactly (one weight of
    1); paged equals contiguous."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.paged_attention import (gather_pages,
                                                     paged_decode_attention)
    g = torch.Generator(device=dev).manual_seed(10)
    B, W, ps = 2, 1024, 16
    NP = W // ps
    q, kc, vc = _bf16_cache(dev, g, B, Hq, Hkv, D, W, dtype)
    mask = torch.arange(W, device=dev)[None, :] <= torch.tensor(
        [[0], [W - 1]], device=dev)
    got = decode_attention(q, kc, vc, mask)
    torch.testing.assert_close(
        got.float(), decode_attention_plain(q, kc, vc, mask).float(),
        **_tol(dtype))
    assert torch.equal(got[0], vc[0, 0].repeat_interleave(Hq // Hkv, dim=0))
    # the same rows through a page table: pages in reverse order
    pt = torch.arange(B * NP, device=dev, dtype=torch.int32) \
        .flip(0).reshape(B, NP)
    pool = [torch.empty((B * NP, ps, Hkv, D), dtype=dtype, device=dev)
            for _ in range(2)]
    for p, t in zip(pool, (kc, vc)):
        p[pt.long()] = t.reshape(B, NP, ps, Hkv, D)
        assert torch.equal(gather_pages(p, pt), t)
    assert torch.equal(paged_decode_attention(q, *pool, pt, mask), got)


@pytest.mark.parametrize("Hq,Hkv,D", [(36, 36, 64), (16, 16, 128),
                                      (8, 1, 32), (32, 2, 128),
                                      (32, 8, 160)])
def test_kernels_rows_do_not_depend_on_their_batch(dev, Hq, Hkv, D):
    """The bf16 pair: each sequence alone gives the bits it gives inside
    a batch of 4, contiguous and paged."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_attention import paged_decode_attention
    g = torch.Generator(device=dev).manual_seed(11)
    B, W = 4, 1024
    q, kc, vc = _bf16_cache(dev, g, B, Hq, Hkv, D, W, torch.bfloat16)
    mask = torch.arange(W, device=dev)[None, :] <= torch.tensor(
        [[1023], [700], [300], [12]], device=dev)
    batch = decode_attention(q, kc, vc, mask)
    q2, (kp, vp), pt, _ = _paged_inputs(dev, g, B, Hq, Hkv, D, 16, 64, W,
                                        torch.bfloat16, False)
    pbatch = paged_decode_attention(q2, kp, vp, pt, mask)
    for i in range(B):
        one = slice(i, i + 1)
        alone = decode_attention(*(t[one].contiguous()
                                   for t in (q, kc, vc, mask)))
        assert torch.equal(alone[0], batch[i])
        palone = paged_decode_attention(
            q2[one].contiguous(), kp, vp, pt[one].contiguous(),
            mask[one].contiguous())
        assert torch.equal(palone[0], pbatch[i])


@pytest.mark.parametrize("kernel,types,count", [
    ("quant_split_kernel", r"(f|13__nv_bfloat16)", 24),  # 2 q dtypes
    ("split_rows_kernel", r"13__nv_bfloat16", 12),      # bf16 KV
])
def test_quant_split_kernel_has_no_spills(dev, kernel, types, count):
    """ptxas reports no spill in the split kernels' G-1 instantiations,
    the ones serving runs: the int8 pair's, and the bf16 pair's in bf16
    (f32 is held to correctness only)."""
    import re
    log = (_build.build_library().parent / "build.log").read_text()
    found = [spill for name, _, spill in _build.ptxas_entries(log)
             if re.search(kernel + r"I" + types + r"Li\d+ELi1ELb[01]E",
                          name)]
    assert found == [0] * count        # x 6 head dims x paged


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


@pytest.mark.parametrize("T,d,f,E,first", [
    (64, 512, 300, 6, 5),
    (4096, 2048, 1408, 60, 16),    # qwen2-moe: decode rows in a prefill
    (4096, 1408, 2048, 60, 16),
])
def test_moe_gemm_rows_do_not_depend_on_their_batch(dev, T, d, f, E, first):
    """A row's result is the same whether it is sorted alone or with
    others: paged and contiguous serving give one stream. At qwen2-moe's
    widths the first 16 rows alone (one or two real rows a block, as at
    decode) equal the same rows inside a 4,096-row batch (full blocks)."""
    from repro_torch.kernels.moe_gemm import moe_gemm
    g = torch.Generator(device=dev).manual_seed(9)
    x, w, eor = _moe_case(dev, g, T, d, f, E, torch.bfloat16)
    full = moe_gemm(x, w, eor, n_experts=E)
    assert torch.equal(moe_gemm(x[:first], w, eor[:first], n_experts=E),
                       full[:first])


def _moe_blocks(dev, g, blocks, d, f, E, offset=0):
    """A padded layout by hand: ``blocks`` lists (expert, real rows) per
    block, each expert's blocks adjacent and full but the last, as the
    sort leaves them; then one trailing block (expert E, no row). x and w
    start ``offset`` elements past a 16-byte boundary when it is > 0.
    Padding rows hold NaN: the kernel must not read them."""
    from repro_torch.kernels.moe_gemm import BLOCK_M
    nb = len(blocks) + 1
    x = torch.full((nb * BLOCK_M * d + offset,), float("nan"), device=dev,
                   dtype=torch.bfloat16)[offset:].view(nb * BLOCK_M, d)
    for i, (_, n) in enumerate(blocks):
        x[i * BLOCK_M:i * BLOCK_M + n] = torch.randn(
            n, d, device=dev, generator=g).to(torch.bfloat16)
    w = (torch.randn(E * d * f + offset, device=dev, generator=g)
         / d ** 0.5).to(torch.bfloat16)[offset:].view(E, d, f)
    be = torch.tensor([e for e, _ in blocks] + [E], dtype=torch.int32,
                      device=dev)
    rows = torch.tensor([n for _, n in blocks] + [0], dtype=torch.int32,
                        device=dev)
    real = (torch.arange(BLOCK_M, device=dev)[None, :]
            < rows[:, None]).reshape(-1)
    return x, w, be, rows, real


def _check_moe_blocks(x, w, be, rows, real):
    from repro_torch.kernels.moe_gemm import (grouped_gemm_padded,
                                              grouped_gemm_padded_plain)
    n = grouped_gemm_padded.launches
    got = grouped_gemm_padded(x, w, be, rows)
    assert grouped_gemm_padded.launches == n + 1
    want = grouped_gemm_padded_plain(x, w, be, rows)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got[real].float()).all())
    torch.testing.assert_close(got[real].float(), want[real].float(),
                               **_tol(torch.bfloat16))


@pytest.mark.parametrize("fill", [1, 15, 16, 17, 63, 64])
def test_moe_gemm_mma_block_fills(dev, fill):
    """The bf16 tensor-core body at every m16 slice boundary of a block:
    an expert of one block, of two (starting at an odd block) and of
    three (a pair and a single), each ending in ``fill`` real rows,
    beside one-row and two-row blocks."""
    g = torch.Generator(device=dev).manual_seed(11)
    blocks = [(0, fill), (1, 64), (1, fill), (2, 64), (2, 64), (2, fill),
              (3, 1), (4, 2)]
    _check_moe_blocks(*_moe_blocks(dev, g, blocks, 512, 384, 5))


@pytest.mark.parametrize("d,f,offset", [
    (48, 40, 0),       # d below one stage, f below one column tile
    (100, 300, 0),     # d and f not multiples of 8: element-wise loads
    (264, 77, 0),      # odd f: element-wise output stores
    (256, 384, 3),     # x and w off a 16-byte boundary
    (128, 200, 0),     # bulk copies, a ragged last column tile
    (64, 136, 0),      # bulk copies, one stage
])
def test_moe_gemm_mma_ragged(dev, d, f, offset):
    g = torch.Generator(device=dev).manual_seed(12)
    blocks = [(0, 64), (0, 37), (1, 1), (2, 16), (3, 64), (3, 17)]
    _check_moe_blocks(*_moe_blocks(dev, g, blocks, d, f, 4, offset))


@pytest.mark.parametrize("T,d,f,E", [
    (16, 2048, 1408, 60),        # qwen2-moe decode, gate/up
    (16, 1408, 2048, 60),        # qwen2-moe decode, down
    (4096, 2048, 1408, 60),      # qwen2-moe 1024-token prefill
    (4096, 1408, 2048, 60),
    (8, 6144, 16384, 8),         # mixtral-8x22b decode, gate/up
])
def test_moe_gemm_mma_full_width(dev, T, d, f, E):
    from repro_torch.kernels.moe_gemm import (
        BLOCK_M, block_rows, grouped_gemm_padded, grouped_gemm_padded_plain,
        sort_by_expert)
    g = torch.Generator(device=dev).manual_seed(13)
    x, w, eor = _moe_case(dev, g, T, d, f, E, torch.bfloat16, empty=(0,))
    xp, be, inv, Tp = sort_by_expert(x, eor, E, BLOCK_M)
    rows = block_rows(inv, Tp // BLOCK_M, BLOCK_M)
    n = grouped_gemm_padded.launches
    got = grouped_gemm_padded(xp, w, be, rows)[inv]
    assert grouped_gemm_padded.launches == n + 1
    torch.testing.assert_close(
        got.float(), grouped_gemm_padded_plain(xp, w, be, rows)[inv].float(),
        **_tol(torch.bfloat16))


def test_moe_layer_sort_once_equals_three_dispatches(dev, monkeypatch):
    """The dropless MoE layer's one sort per layer gives the logits and
    tokens of three ``moe_gemm`` calls, bit for bit, in bf16 on the card
    (smoke qwen2-moe, prefill then greedy decode steps)."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.kernels.moe_gemm import grouped_gemm_padded, moe_gemm
    from repro_torch.models import (ModelRuntime, decode_step, init_params,
                                    prefill)
    from repro_torch.models import moe as MOE
    cfg = smoke_config(ARCHS["qwen2-moe-a2.7b"])
    rt = ModelRuntime(moe_dropless=True)
    params = init_params(cfg, seed=0, rt=rt)
    g = torch.Generator(device=dev).manual_seed(14)
    toks = torch.randint(0, cfg.vocab_size, (3, 20), device=dev, generator=g)
    lengths = torch.tensor([20, 9, 4], dtype=torch.int32, device=dev)

    def run():
        n = grouped_gemm_padded.launches
        with torch.no_grad():
            cache, log = prefill(params, cfg, {"tokens": toks}, 32, rt,
                                 lengths=lengths)
            logs = [log]
            for _ in range(5):
                cache, log = decode_step(params, cfg, cache,
                                         logs[-1].argmax(-1), rt)
                logs.append(log)
        assert grouped_gemm_padded.launches - n == 3 * cfg.n_layers * 6
        return torch.stack(logs)

    once = run()

    def three(x, wg, wi, wo, eor, act, *, n_experts):
        h = act(moe_gemm(x, wg, eor, n_experts=n_experts),
                moe_gemm(x, wi, eor, n_experts=n_experts))
        return moe_gemm(h, wo, eor, n_experts=n_experts)

    monkeypatch.setattr(MOE, "moe_gemm_glu", three)
    assert once.dtype == torch.bfloat16
    assert torch.equal(once, run())


# ---------------------------------------------------------------- ssd
#: f32 SSD scan: each output sums up to a chunk of products over a
#: 128-wide state, weighted by exp() of cumulative sums of up to 256
#: steps.
SSD_F32_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,S,nh,hp,N,chunk", [
    (1, 1024, 64, 64, 128, 256),   # mamba2-1.3b prefill
    (2, 300, 4, 64, 128, 256),     # ragged last chunk
    (1, 16, 3, 32, 16, 256),       # S < chunk
    (2, 100, 2, 16, 8, 32),        # hp 16, small state
    (2, 700, 64, 64, 128, 256),    # mamba2 widths, b 2, ragged S
    (1, 1024, 8, 64, 128, 64),     # 16 chunks
    (1, 130, 2, 32, 12, 64),       # N % 8 != 0: the CUDA-core body
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


def test_ssd_scan_kernel_is_deterministic(dev):
    """The chunk-parallel scan has no atomics: a bf16 rerun at mamba2's
    widths equals the first run bit for bit."""
    from repro_torch.kernels.ssd_scan import ssd_scan
    g = torch.Generator(device=dev).manual_seed(11)
    b, S, nh, hp, N = 2, 700, 64, 64, 128
    x = torch.randn(b, S, nh, hp, device=dev, generator=g).bfloat16()
    dt = torch.nn.functional.softplus(
        torch.randn(b, S, nh, device=dev, generator=g) - 2.0)
    A = -torch.exp(torch.randn(nh, device=dev, generator=g) * 0.5)
    B, C = (torch.randn(b, S, nh, N, device=dev, generator=g).bfloat16()
            for _ in range(2))
    y1, h1 = ssd_scan(x, dt, A, B, C, chunk=256)
    y2, h2 = ssd_scan(x, dt, A, B, C, chunk=256)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.parametrize("a_init", ["served", "random"])
@pytest.mark.parametrize("b,S", [(1, 1024), (2, 700)])
def test_ssd_scan_equals_the_plain_version_bit_for_bit(dev, a_init, b, S):
    """At mamba2-1.3b's widths in bf16 (64 heads of 64, state 128, chunk
    256) the scan sums in the plain version's order and rounds where it
    rounds: y and the final state equal ``ssd_chunked``'s bit for bit.
    A = -1 as the model initialises it (``A_log`` 0), and random A,
    where dt * A is not exact and the cumulative sum's rounding shows."""
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
    g = torch.Generator(device=dev).manual_seed(S + b)
    nh, hp, N = 64, 64, 128
    x = torch.randn(b, S, nh, hp, device=dev, generator=g).bfloat16()
    dt = torch.nn.functional.softplus(
        torch.randn(b, S, nh, device=dev, generator=g) - 2.0)
    A = (-torch.ones(nh, device=dev) if a_init == "served" else
         -torch.exp(torch.randn(nh, device=dev, generator=g) * 0.5))
    B, C = (torch.randn(b, S, nh, N, device=dev, generator=g).bfloat16()
            for _ in range(2))
    y, h = ssd_scan(x, dt, A, B, C, chunk=256)
    yw, hw = ssd_chunked(x, dt, A, B, C, 256)
    assert torch.equal(y, yw) and torch.equal(h, hw)


@pytest.mark.parametrize("a_init", ["served", "random"])
@pytest.mark.parametrize("b,S", [(1, 1024), (2, 700)])
def test_ssd_scan_equals_the_plain_version_at_zamba2_widths(dev, a_init, b,
                                                            S):
    """zamba2-2.7b's Mamba-2 widths in bf16 (80 heads of 64, state 64,
    chunk 256): y and the final state equal ``ssd_chunked``'s bit for
    bit, as at mamba2's state of 128."""
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan
    g = torch.Generator(device=dev).manual_seed(3 * S + b)
    nh, hp, N = 80, 64, 64
    x = torch.randn(b, S, nh, hp, device=dev, generator=g).bfloat16()
    dt = torch.nn.functional.softplus(
        torch.randn(b, S, nh, device=dev, generator=g) - 2.0)
    A = (-torch.ones(nh, device=dev) if a_init == "served" else
         -torch.exp(torch.randn(nh, device=dev, generator=g) * 0.5))
    B, C = (torch.randn(b, S, nh, N, device=dev, generator=g).bfloat16()
            for _ in range(2))
    y, h = ssd_scan(x, dt, A, B, C, chunk=256)
    yw, hw = ssd_chunked(x, dt, A, B, C, 256)
    assert torch.equal(y, yw) and torch.equal(h, hw)


@pytest.mark.parametrize("label,pattern", _build.SERVED_BUILDS)
def test_served_scan_and_norm_bodies_have_no_spills(dev, label, pattern):
    """ptxas reports no spill in the instantiations the served shapes run
    in bf16 (``_build.SERVED_BUILDS``): the SSD scan's three kernels at
    mamba2's widths, RMSNorm at the served widths, prefill and decode
    row counts, and the split-KV kernels at the served groups past 1
    (D 128 at G 7, 12 and 16; D 160 at G 4)."""
    import re
    log = (_build.build_library().parent / "build.log").read_text()
    found = [spill for name, _, spill in _build.ptxas_entries(log)
             if re.search(pattern, name)]
    assert found == [0], (label, found)


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


#: chip_smoke.py's f32 bar (summation order only).
F32_TOL = dict(atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,K,N,offset", [
    (17, 40, 1000, 0),         # K 40: a stage and a ragged one
    (128, 2304, 17280, 0),     # one block height, minicpm-2b's widths
    (1000, 2300, 1000, 0),     # K not a stage multiple, N % 16 != 0
    (1024, 2304, 17280, 0),    # the served prefill slice
    (1000, 2304, 1000, 1),     # unaligned weight: byte loads
    (17, 2300, 17280, 0),      # K % 8 != 0: x loaded element by element
])
def test_quant_matmul_mma_kernel(dev, dtype, T, K, N, offset):
    """The tensor-core body (T > 16): bf16 x as one piece, f32 x as three
    exact bf16 pieces, held to the file's bars and to chip_smoke.py's."""
    from repro_torch.kernels.quant import quant_matmul, quant_matmul_plain
    g = torch.Generator(device=dev).manual_seed(16)
    x, w_q, scale = _qmm_case(dev, g, T, K, N, dtype, offset)
    n = quant_matmul.launches
    got = quant_matmul(x, w_q, scale)
    assert quant_matmul.launches == n + 1
    assert got.dtype == dtype and tuple(got.shape) == (T, N)
    want = quant_matmul_plain(x, w_q, scale)
    assert not bool(got[:, 0].any())
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32_TOL if dtype == torch.float32
                                  else BF16_TOL))


@pytest.mark.parametrize("T,K,N", [(1024, 2304, 17280), (333, 2048, 1000)])
def test_quant_matmul_mma_kernel_unscaled_f32(dev, T, K, N):
    """f32 x at the tuner's unscaled N(0, 1) magnitudes (outputs near 48
    in RMS): F32_TOL with its atol taken relative to the output's RMS, as
    chip_smoke.py holds the tuner's cases."""
    from repro_torch.kernels.quant import (quant_matmul, quant_matmul_plain,
                                           quantize_channels)
    g = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(T, K, device=dev, generator=g)
    w_q, scale = quantize_channels(torch.randn(K, N, device=dev,
                                               generator=g))
    n = quant_matmul.launches
    got = quant_matmul(x, w_q, scale)
    assert quant_matmul.launches == n + 1
    want = quant_matmul_plain(x, w_q, scale)
    rms = max(1.0, float(want.square().mean().sqrt()))
    torch.testing.assert_close(got, want, atol=F32_TOL["atol"] * rms,
                               rtol=F32_TOL["rtol"])


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


# ---------------------------------------------------------------- train
#: f32 training, cuda vs torch policy (TF32 off): the loss within 1e-5 of
#: itself; gradients within 1e-3 of the largest (the reference's bar for
#: its kernels under autograd, tests/test_kernel_dispatch.py); a single
#: MoE layer's within 1e-4 of each leaf's largest (its kernel and plain
#: forward differ in summation order only).
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, MOE_LAYER_GRAD_RTOL = 1e-5, 1e-3, 1e-4


def _grads_rel(a, b):
    """max|a - b| / max|b| over all leaves of two gradient trees."""
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return (max(float((x - y).abs().max()) for x, y in zip(la, lb))
            / max(float(y.abs().max()) for y in lb))


def test_sort_once_moe_layer_gradients_match_torch_policy(dev):
    """The dropless layer's one-sort grouped GEMMs run forward on the card
    under autograd and carry the three-dispatch torch path's gradients
    to x, the router and every expert weight (f32, small width)."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.kernels.dispatch import CUDA_POLICY, TORCH_POLICY
    from repro_torch.kernels.moe_gemm import grouped_gemm_padded
    from repro_torch.models import init_params
    from repro_torch.models import moe as MOE
    cfg = smoke_config(ARCHS["qwen2-moe-a2.7b"])
    blocks = init_params(cfg, seed=3, device=dev)["blocks"]["moe"]
    g = torch.Generator(device=dev).manual_seed(15)
    x0 = torch.randn(2, 37, cfg.d_model, device=dev, generator=g)
    w = torch.randn(2, 37, cfg.d_model, device=dev, generator=g)
    grads = {}
    for name, pol in (("torch", TORCH_POLICY), ("cuda", CUDA_POLICY)):
        p = {k: v[0].detach().clone().requires_grad_()
             for k, v in blocks.items()}
        x = x0.clone().requires_grad_()
        n = grouped_gemm_padded.launches
        y, aux = MOE.moe_ffn(p, x, cfg, dropless=True, policy=pol)
        assert grouped_gemm_padded.launches - n == (3 if name == "cuda"
                                                    else 0)
        ((y * w).sum() + aux).backward()
        assert grouped_gemm_padded.launches - n == (3 if name == "cuda"
                                                    else 0)
        grads[name] = {"x": x.grad, **{k: v.grad for k, v in p.items()}}
    for k, want in grads["torch"].items():
        got = grads["cuda"][k]
        assert got is not None and bool(torch.isfinite(got).all()), k
        d = float((got - want).abs().max())
        assert d <= MOE_LAYER_GRAD_RTOL * float(want.abs().max()), (k, d)


def test_zamba2_gradients_match_torch_policy(dev):
    """Full-width zamba2-2.7b cut to one group (6 Mamba-2 layers and one
    shared attention block at D 80), f32, B 2, S 128: loss and every
    gradient, the shared blocks' included, under cuda against torch; the
    cuda pass runs RMSNorm, flash and the scan forward only."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.models import ModelRuntime, init_params
    from repro_torch.train.loop import value_and_grad
    cfg = ARCHS["zamba2-2.7b"]
    cfg = dataclasses.replace(cfg, n_layers=cfg.shared_attn_period)
    params = init_params(cfg, seed=1, device=dev)
    g = torch.Generator(device=dev).manual_seed(18)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 128), device=dev,
                              generator=g, dtype=torch.int32)
             for k in ("tokens", "labels")}
    counters = _counters()
    out = {}
    for pol in ("torch", "cuda"):
        rt = ModelRuntime(dtype="float32", remat="none",
                          kernels=getattr(KernelPolicy, pol)())
        before = {k: c.launches for k, c in counters.items()}
        out[pol] = value_and_grad(cfg, rt, params, batch)
        ran = {k: c.launches - before[k] for k, c in counters.items()}
        assert ran == ({"rmsnorm": 2 * 6 + 2 + 1, "flash_attention": 1,
                        "moe_gemm": 0, "ssd_scan": 6} if pol == "cuda"
                       else dict.fromkeys(ran, 0)), ran
    (lc, _, gc), (lt, _, gt) = out["cuda"], out["torch"]
    assert float((lc - lt).abs() / lt.abs()) < TRAIN_LOSS_RTOL
    assert _grads_rel(gc, gt) < TRAIN_GRAD_RTOL
    assert _grads_rel(gc["shared"], gt["shared"]) < TRAIN_GRAD_RTOL


@pytest.mark.parametrize("name,kernels", [
    ("minicpm-2b", ("rmsnorm", "flash_attention")),
    ("qwen2-moe-a2.7b", ("rmsnorm", "flash_attention", "moe_gemm")),
    ("mamba2-1.3b", ("rmsnorm", "ssd_scan"))])
def test_two_layer_model_trains_as_torch_policy(dev, name, kernels):
    """Full width, 2 layers, f32, B 2, S 128 (qwen2-moe dropless): loss
    and every gradient under cuda against torch; the cuda pass runs the
    model's kernels forward only (backward is the plain versions'
    autograd, so it launches none)."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.kernels.dispatch import KernelPolicy
    from repro_torch.models import ModelRuntime, init_params
    from repro_torch.train.loop import value_and_grad
    cfg = dataclasses.replace(ARCHS[name], n_layers=2)
    params = init_params(cfg, seed=1, device=dev)
    g = torch.Generator(device=dev).manual_seed(16)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 128), device=dev,
                              generator=g, dtype=torch.int32)
             for k in ("tokens", "labels")}
    counters = _counters()
    out = {}
    for pol in ("torch", "cuda"):
        rt = ModelRuntime(dtype="float32", remat="none",
                          moe_dropless=True,
                          kernels=getattr(KernelPolicy, pol)())
        before = {k: c.launches for k, c in counters.items()}
        out[pol] = value_and_grad(cfg, rt, params, batch)
        ran = {k: c.launches - before[k] for k, c in counters.items()}
        assert {k for k, n in ran.items() if n} == (
            set(kernels) if pol == "cuda" else set()), ran
    (lc, mc, gc), (lt, mt, gt) = out["cuda"], out["torch"]
    assert float((lc - lt).abs() / lt.abs()) < TRAIN_LOSS_RTOL
    assert float((mc["aux"] - mt["aux"]).abs()) < 1e-6
    assert _grads_rel(gc, gt) < TRAIN_GRAD_RTOL


def _counters():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gemm import grouped_gemm_padded
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "moe_gemm": grouped_gemm_padded, "ssd_scan": ssd_scan}


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2-moe-a2.7b",
                                  "mamba2-1.3b", "zamba2-2.7b"])
def test_serving_launches_unchanged_by_autograd(dev, arch):
    """Weights that require grad change nothing under ``torch.no_grad()``
    (the same launches, no graph); with grad the forward launches the
    same kernels and, with remat none, the backward launches none."""
    from repro_torch.configs import ARCHS, smoke_config
    from repro_torch.models import ModelRuntime, forward, init_params
    from repro_torch.tree import tree_map
    cfg = smoke_config(ARCHS[arch])
    rt = ModelRuntime(dtype="float32", remat="none", moe_dropless=True)
    params = init_params(cfg, seed=2, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))
    counters = _counters()

    def launches(fn):
        before = {k: c.launches for k, c in counters.items()}
        out = fn()
        torch.cuda.synchronize()
        return out, {k: c.launches - before[k] for k, c in counters.items()}

    with torch.no_grad():
        served, n_served = launches(lambda: forward(
            params, cfg, {"tokens": toks}, rt)[0])
    leaves = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    with torch.no_grad():
        again, n_again = launches(lambda: forward(
            leaves, cfg, {"tokens": toks}, rt)[0])
    assert again.grad_fn is None and n_again == n_served
    assert torch.equal(again, served)
    logits, n_grad = launches(lambda: forward(
        leaves, cfg, {"tokens": toks}, rt)[0])
    assert logits.grad_fn is not None and n_grad == n_served
    assert torch.equal(logits.detach(), served)
    _, n_back = launches(lambda: logits.float().square().mean().backward())
    assert not any(n_back.values()), n_back


@pytest.mark.parametrize("arch", ["minicpm-2b", "mamba2-1.3b"])
def test_remat_recomputes_the_kernels_and_keeps_the_gradients(dev, arch):
    """``dots`` and ``full`` checkpoint each block around the kernels'
    autograd function: the backward runs the block's forward again, its
    kernels included (one launch each per block), and the gradients
    are those of ``none`` within 1e-6 of the largest (the embedding's
    backward adds rows with atomics, in no fixed order on the card)."""
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.models import ModelRuntime, init_params
    from repro_torch.train.loop import value_and_grad
    cfg = dataclasses.replace(ARCHS[arch], n_layers=2)
    params = init_params(cfg, seed=5, device=dev)
    g = torch.Generator(device=dev).manual_seed(17)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), device=dev,
                              generator=g, dtype=torch.int32)
             for k in ("tokens", "labels")}
    counters = _counters()
    out = {}
    for remat in ("none", "dots", "full"):
        rt = ModelRuntime(dtype="float32", remat=remat)
        before = {k: c.launches for k, c in counters.items()}
        out[remat] = value_and_grad(cfg, rt, params, batch)
        torch.cuda.synchronize()
        out[remat] += ({k: c.launches - before[k]
                        for k, c in counters.items()},)
    base = out["none"][3]
    assert any(base.values())
    for remat in ("dots", "full"):
        loss, _, grads, ran = out[remat]
        # the recomputed blocks launch their kernels again; the final
        # norm lies outside every block
        assert ran["rmsnorm"] == 2 * base["rmsnorm"] - 1, (remat, ran)
        for k in ("flash_attention", "ssd_scan"):
            assert ran[k] == 2 * base[k], (remat, ran)
        assert torch.equal(loss, out["none"][0])
        assert _grads_rel(grads, out["none"][2]) < 1e-6, remat


def _meta(*specs):
    return tuple(torch.empty(sh, dtype=dt, device="meta") for sh, dt in specs)


_BF, _F32, _I8 = torch.bfloat16, torch.float32, torch.int8
#: One case per kernel: (op, operands as (shape, dtype), call kwargs).
_PLAN_CASES = (
    ("rmsnorm", (((2048, 2304), _BF), ((2304,), _F32)), {}),
    ("prefill_attention", (((1, 700, 36, 64), _BF),) * 3,
     {"causal": True, "window": 0}),
    ("decode_attention", (((4, 24, 128), _BF), ((4, 1000, 2, 128), _BF),
                          ((4, 1000, 2, 128), _BF), ((4, 1000), torch.bool)),
     {}),
    ("paged_decode_attention",
     (((4, 36, 64), _F32), ((65, 16, 36, 64), _F32),
      ((65, 16, 36, 64), _F32), ((4, 16), torch.int32),
      ((4, 256), torch.bool)), {}),
    ("quant_decode_attention",
     (((4, 32, 160), _BF), ((4, 300, 8, 160), _I8), ((4, 300, 8, 160), _I8),
      ((4, 300, 8), _BF), ((4, 300, 8), _BF), ((4, 300), torch.bool)), {}),
    ("quant_paged_decode_attention",
     (((2, 32, 128), _BF), ((17, 16, 2, 128), _I8), ((17, 16, 2, 128), _I8),
      ((17, 16, 2), _BF), ((17, 16, 2), _BF), ((2, 8), torch.int32),
      ((2, 128), torch.bool)), {}),
    ("moe_gemm", (((1000, 2048), _BF), ((60, 2048, 1408), _BF),
                  ((1000,), torch.int32)), {"n_experts": 60}),
    ("quant_matmul", (((37, 2300), _F32), ((2300, 1000), _I8),
                      ((1000,), _F32)), {}),
    ("ssd_scan", (((2, 700, 8, 64), _BF), ((2, 700, 8), _F32), ((8,), _F32),
                  ((2, 700, 8, 32), _BF), ((2, 700, 8, 32), _BF)),
     {"chunk": 256}),
)


@pytest.mark.parametrize("op,specs,kw", _PLAN_CASES,
                         ids=[c[0] for c in _PLAN_CASES])
def test_launch_plan_equals_the_librarys(dev, op, specs, kw):
    """The Python plan of one case per kernel equals the library's plan
    export (name, grid, block, dynamic shared memory), and each kernel's
    static shared memory the compiled kernel's."""
    from repro_torch.kernels import plan as P
    from repro_torch.kernels.dispatch import implementations
    fn = implementations(op)["cuda"]
    args = _meta(*specs)
    plan = fn.launch_plan(*args, **kw)
    lib = fn.library_plan(*args, **kw)
    assert plan.geometry() == [x.geometry() for x in lib]
    for mine, theirs in zip(plan.launches, lib):
        assert P.kernel_attributes(theirs)["smem_static"] == \
            mine.smem_static, mine.kernel


def _wrappers():
    """Every kernel wrapper by the name the graph lint's kernel nodes
    carry (its launch counter)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gemm import grouped_gemm_padded
    from repro_torch.kernels.paged_attention import paged_decode_attention
    from repro_torch.kernels.quant import (quant_decode_attention,
                                           quant_matmul,
                                           quant_paged_decode_attention)
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"rmsnorm": rmsnorm, "flash_attention": flash_attention,
            "decode_attention": decode_attention,
            "paged_decode_attention": paged_decode_attention,
            "quant_decode_attention": quant_decode_attention,
            "quant_paged_decode_attention": quant_paged_decode_attention,
            "moe_gemm": grouped_gemm_padded, "ssd_scan": ssd_scan,
            "quant_matmul": quant_matmul}


@pytest.mark.parametrize("kv,paged", [(None, False), (None, True),
                                      ("int8", False), ("int8", True)])
@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen2-moe-a2.7b",
                                  "mamba2-1.3b", "zamba2-2.7b"])
def test_traced_decode_kernels_are_the_launches(dev, arch, kv, paged):
    """The kernel nodes of a decode step traced on meta
    (``graph_lint.decode_kernels``) equal the wrappers' launches over
    one eager step on the card at the same shapes (smoke configs)."""
    import dataclasses
    from repro_torch.analysis.graph_lint import decode_case, decode_kernels
    from repro_torch.configs import get_arch, smoke_config
    from repro_torch.models import ModelRuntime, init_params
    cfg = smoke_config(get_arch(arch))
    rt = ModelRuntime(moe_dropless=True, kv_dtype=kv)
    ps = 8 if paged else None
    traced = decode_kernels(cfg, rt, batch=2, max_len=64, page_size=ps)
    params = init_params(cfg, seed=0, rt=rt)
    fn, spec, _ = decode_case(cfg, rt, batch=2, max_len=64, page_size=ps)
    cache = {k: torch.zeros(s, dtype=d, device=dev)
             for k, (s, d) in spec.items()}
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    with torch.no_grad():
        fn(params, cache, torch.zeros((2,), dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    launched = {k: w.launches for k, w in wrappers.items() if w.launches}
    assert launched == dict(traced)
