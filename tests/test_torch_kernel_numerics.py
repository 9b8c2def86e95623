"""The precision arguments behind the tensor-core kernels, checked with
torch on the CPU (no card needed).

The bf16 flash body multiplies P (the f32 softmax weights) into V on
bf16 tensor cores, and the int8-weight matmul multiplies f32 x on them.
Both split the f32 operand into bf16 pieces whose products are exact in
f32, so the result differs from the plain f32 version only in summation
order; these tests show that the chosen number of pieces keeps each
kernel within ``chip_smoke.py``'s bar, and that one piece fewer does
not. They also check the exact int8 -> bf16 conversion the matmul
kernel uses, and that the split-KV decode kernels' order of work (the
lanes' partial dot products, for int8 with the row scale factored out,
the lanes and rows summed in their shuffle order, P.V as p * v or
(p * vs) * v) stays within the same bars, for the bf16/f32 and the int8
pair. The SSD scan's order of work (a serial f32 cumulative sum, each
dot product one fma chain in index order) is modelled at mamba2-1.3b's
widths and held to the same bars. Inputs are drawn with numpy from fixed
seeds.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

#: chip_smoke.py's bars: bf16 outputs one ulp apart, f32 summation order.
BF16_TOL = dict(atol=1e-5, rtol=2 ** -7)
F32_TOL = dict(atol=5e-5, rtol=1e-5)


def _breaks(got, want, tol):
    """How many outputs miss ``|got - want| <= atol + rtol |want|``."""
    err = (got.float() - want.float()).abs()
    return int((err > tol["atol"] + tol["rtol"] * want.float().abs()).sum())


def _bf16_pieces(x: torch.Tensor, n: int):
    """x (f32) as n bf16 pieces, each the rounding of what is left."""
    pieces, rest = [], x.float()
    for _ in range(n):
        p = rest.to(torch.bfloat16)
        pieces.append(p)
        rest = rest - p.float()
    return pieces


def _causal_softmax_v(S, H, D, seed):
    """bf16 q, k, v; the f32 causal softmax weights P (unnormalized, as
    the online softmax keeps them), their row sums and V in f32."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((H, S, D))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    s = q.float() @ k.float().transpose(1, 2) / D ** 0.5
    causal = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(causal, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p, p.sum(dim=-1, keepdim=True), v.float()


@pytest.mark.parametrize("S,H,D", [(512, 4, 64), (384, 2, 128)])
def test_split_p_keeps_flash_within_one_bf16_ulp(S, H, D):
    """P as hi + lo bf16 terms keeps softmax(QK^T) V within BF16_TOL of
    the f32 result rounded once; P rounded once to bf16 does not."""
    p, l, v = _causal_softmax_v(S, H, D, seed=S + D)
    want = ((p @ v) / l).to(torch.bfloat16)

    def through(n):
        acc = sum(piece.float() @ v for piece in _bf16_pieces(p, n))
        return (acc / l).to(torch.bfloat16)

    assert _breaks(through(2), want, BF16_TOL) == 0
    assert _breaks(through(1), want, BF16_TOL) > 0


def _quant_case(T, K, N, seed):
    """f32 x of order 1/sqrt(K) per element, an int8 weight with
    per-column scales (column 0 all zero), as the card tests draw them."""
    from repro_torch.kernels.quant import quantize_channels
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((T, K)) / K ** 0.5)
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    w[:, 0] = 0.0
    w_q, scale = quantize_channels(w)
    return x, w_q, scale


@pytest.mark.parametrize("T,K,N", [(64, 2304, 512), (37, 2300, 300)])
def test_three_bf16_pieces_of_f32_x_match_quant_matmul_plain(T, K, N):
    """x = hi + mid + lo exactly; each piece times an int8 weight is
    exact in f32, so hi's products in one sum and mid's and lo's in a
    second stay within F32_TOL of ``quant_matmul_plain``; x rounded once
    to bf16 does not."""
    from repro_torch.kernels.quant import quant_matmul_plain
    x, w_q, scale = _quant_case(T, K, N, seed=T + K)
    want = quant_matmul_plain(x, w_q, scale)
    w = w_q.float()
    hi, mid, lo = _bf16_pieces(x, 3)
    assert torch.equal(hi.float() + mid.float() + lo.float(), x)
    got = (hi.float() @ w + (mid.float() @ w + lo.float() @ w)) * scale
    assert _breaks(got, want, F32_TOL) == 0
    one = (hi.float() @ w) * scale
    assert _breaks(one, want, F32_TOL) > 0


def test_int8_to_bf16_bit_trick_is_exact():
    """The matmul kernel widens an int8 b as the f32 with bits
    0x4B000000 | (b ^ 0x80), less 2^23 + 128, and keeps its top 16 bits
    as the bf16: every b in -128..127 comes out exactly."""
    b = np.arange(-128, 128, dtype=np.int64)
    u = (b.astype(np.uint8) ^ 0x80).astype(np.uint32)
    f = (np.uint32(0x4B000000) | u).view(np.float32) - np.float32(8388736.0)
    assert np.array_equal(f, b.astype(np.float32))
    bits = f.view(np.uint32)
    assert not (bits & 0xFFFF).any()            # the low half is zero
    top = torch.from_numpy((bits >> 16).astype(np.int16))
    assert torch.equal(top.view(torch.bfloat16).float(),
                       torch.from_numpy(b.astype(np.float32)))


def _butterfly(x: torch.Tensor, n: int, step: int = 1) -> torch.Tensor:
    """The xor-shuffle sum over the last axis's groups of ``n`` lanes
    ``step`` apart, offsets n/2 .. 1 (in units of ``step``), as lane 0
    of the group holds it."""
    idx = torch.arange(x.shape[-1])
    off = n // 2
    while off >= 1:
        x = x + x[..., idx ^ (off * step)]
        off //= 2
    return x


def _lane_cols(itemsize: int, G: int) -> int:
    """Columns a lane of the split-KV body owns (splitkv.cuh lane_cols):
    one 16-byte load at G 1, at most 8 at G 2 and 4 at G > 2."""
    return min(16 // itemsize, 16 if G == 1 else 8 if G == 2 else 4)


def _splitkv_emulated(q, k, v, mask, ks=None, vs=None):
    """The split-KV kernels' arithmetic (splitkv.cuh split_rows), order
    for order: C-column lane partials of q . k, the L = D / C lanes
    summed by xor shuffles, then (int8) the K scale and 1/sqrt(D);
    split-local max and sum; each lane's p * v (int8: (p * vs) * v) over
    its L rows, the 32 / L rows of a warp summed by xor shuffles, the 4
    warps in order; the LSE merge. k, v: (B, W, Hkv, D), int8 with the
    (B, W, Hkv) scales ks, vs, or float / bf16 without."""
    B, Hq, D = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    assert W % 128 == 0
    C, BK = _lane_cols(k.element_size(), G), 128
    L = D // C
    ns, RP = W // BK, BK // L
    qf = q.float().reshape(B, Hkv, G, 1, L, C)
    kf = k.float().permute(0, 2, 1, 3).reshape(B, Hkv, 1, W, L, C)
    part = torch.zeros(B, Hkv, G, W, L)
    for u in range(C):                             # one lane's FMA chain
        part = part + qf[..., u] * kf[..., u]
    s = _butterfly(part, L)[..., 0]                # lane 0 of each row
    row = mask[:, None, None, :]
    if ks is not None:
        s = s * ks.float().permute(0, 2, 1)[:, :, None, :]
    s = s * (torch.tensor(1.0) / torch.sqrt(torch.tensor(float(D))))
    s = torch.where(row, s, torch.full_like(s, -1e30))
    s = s.reshape(B, Hkv, G, ns, BK)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if vs is not None:
        vsc = torch.where(mask[:, None, :], vs.float().permute(0, 2, 1),
                          torch.zeros(()))
        p = p * vsc.reshape(B, Hkv, 1, ns, BK)
    vf = torch.where(mask[:, None, :, None],
                     v.float().permute(0, 2, 1, 3), torch.zeros(()))
    vf = vf.reshape(B, Hkv, 1, ns, L, RP, D)       # row = pass * RP + slot
    p = p.reshape(B, Hkv, G, ns, L, RP, 1)
    acc = torch.zeros(B, Hkv, G, ns, RP, D)
    for pas in range(L):                           # each lane's FMA chain
        acc = acc + p[:, :, :, :, pas] * vf[:, :, :, :, pas]
    acc = acc.reshape(B, Hkv, G, ns, 4, 32 // L, D)  # (warp, slot in warp)
    acc = _butterfly(acc.transpose(-1, -2), 32 // L)[..., 0]
    o = acc[..., 0, :]
    for w in range(1, 4):
        o = o + acc[..., w, :]
    m_all = m.amax(dim=-1, keepdim=True)
    wgt = torch.exp(m - m_all)
    l_all, out = torch.zeros(B, Hkv, G), torch.zeros(B, Hkv, G, D)
    for i in range(ns):                            # the merge kernel
        l_all = l_all + l[..., i] * wgt[..., i]
        out = out + o[..., i, :] * wgt[..., i, None]
    out = out / torch.clamp(l_all, min=1e-30)[..., None]
    return out.reshape(B, Hq, D).to(q.dtype)


#: chip_smoke.py's positions in a 1024-row window, B 4.
_POS = [[1023], [700], [300], [12]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,D", [(36, 64), (16, 128)])
def test_quant_splitkv_order_stays_within_the_bars(dtype, H, D):
    """At both full-width int8 shapes (minicpm-2b 36 heads of 64,
    qwen2-moe-a2.7b 16 of 128; B 4, W 1024, chip_smoke.py's positions),
    the kernels' order lands within F32_TOL / BF16_TOL of the plain
    version, which dequantizes before the dot products."""
    from repro_torch.kernels.quant import (quant_decode_attention_plain,
                                           quantize_rows)
    rng = np.random.default_rng(H + D)
    B, W = 4, 1024
    q = torch.from_numpy(rng.standard_normal((B, H, D))
                         .astype(np.float32)).to(dtype)
    kq, ks = quantize_rows(torch.from_numpy(
        rng.standard_normal((B, W, H, D)).astype(np.float32)))
    vq, vs = quantize_rows(torch.from_numpy(
        rng.standard_normal((B, W, H, D)).astype(np.float32)))
    mask = torch.arange(W)[None, :] <= torch.tensor(_POS)
    got = _splitkv_emulated(q, kq, vq, mask, ks, vs)
    want = quant_decode_attention_plain(q, kq, vq, ks, vs, mask)
    assert got.dtype == want.dtype == dtype
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert _breaks(got, want, tol) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,D", [(36, 36, 64), (16, 16, 128),
                                      (16, 2, 128)])
def test_splitkv_order_stays_within_the_bars(dtype, Hq, Hkv, D):
    """The bf16/f32 pair's order (C = 8 bf16 / 4 f32 columns a lane at
    G 1, 4 at G 8) at both full-width shapes (minicpm-2b 36 heads of 64,
    qwen2-moe-a2.7b 16 of 128, G 1) and at G 8, B 4, W 1024, lands within
    F32_TOL / BF16_TOL of ``decode_attention_plain``."""
    from repro_torch.kernels.decode_attention import decode_attention_plain
    rng = np.random.default_rng(Hq + Hkv + D)
    B, W = 4, 1024
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(dtype)
               for shape in ((B, Hq, D), (B, W, Hkv, D), (B, W, Hkv, D)))
    mask = torch.arange(W)[None, :] <= torch.tensor(_POS)
    got = _splitkv_emulated(q, k, v, mask)
    want = decode_attention_plain(q, k, v, mask)
    assert got.dtype == want.dtype == dtype
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert _breaks(got, want, tol) == 0



# --------------------------------------------------------------- ssd_scan
def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf(a, b, c) of f32 tensors: the product is exact in f64, the sum
    rounded (twice, which differs from one rounding only at rare ties)."""
    return (a.double() * b.double() + c.double()).float()


def _ssd_kernel_order(x, dt, A, B, C, L):
    """The SSD kernel's order of work (csrc/ssd_scan.cu), with torch on
    the CPU: per chunk one f32 add after another of the rounded products
    dt * A (chunk_cumsum); w = dt * exp(a_last - a); each chunk's state
    (p, n) one fma chain over s of (x_s w_s) B_s; the pass over chunks, h
    = h exp(a_last) + state, rounded apart; the scores one fma chain over
    n; M = (scores * exp(a_t - a_s)) * dt_s; y = (fma chain over s of M x)
    + (fma chain over n of C h) * exp(a_t), rounded once."""
    b, S, nh, hp = x.shape
    N = B.shape[-1]
    nc = -(-S // L)
    pad = nc * L - S

    def chunks(t):
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.ndim - 2)
                                    + (0, pad))
        t = t.reshape(b, nc, L, nh, *t.shape[3:])
        return t.permute(0, 3, 1, 2, *range(4, t.ndim))  # b nh nc L ...

    xc, dtc, Bc, Cc = chunks(x), chunks(dt), chunks(B), chunks(C)
    dA = dtc * A.float()[None, :, None, None]
    a, run = torch.empty_like(dA), torch.zeros(dA.shape[:-1])
    for t in range(L):
        run = run + dA[..., t]
        a[..., t] = run
    a_last = a[..., -1]
    wx = (dtc * torch.exp(a_last[..., None] - a))[..., None] * xc
    state = torch.zeros(b, nh, nc, hp, N)
    for s in range(L):
        state = _fma(wx[..., s, :, None], Bc[..., s, None, :], state)
    h, h_prev = torch.zeros(b, nh, hp, N), []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(a_last[..., c])[..., None, None] + state[:, :, c]
    h_prev = torch.stack(h_prev, 2)
    sc = torch.zeros(b, nh, nc, L, L)
    for n in range(N):
        sc = _fma(Cc[..., :, None, n], Bc[..., None, :, n], sc)
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    M = torch.where(causal, sc * torch.exp(a[..., :, None] - a[..., None, :])
                    * dtc[..., None, :], torch.zeros(()))
    dia = torch.zeros(b, nh, nc, L, hp)
    off = torch.zeros(b, nh, nc, L, hp)
    for s in range(L):
        dia = _fma(M[..., :, s, None], xc[..., s, None, :], dia)
    for n in range(N):
        off = _fma(Cc[..., :, n, None], h_prev[..., None, :, n], off)
    y = dia + off * torch.exp(a)[..., None]
    y = y.permute(0, 2, 3, 1, 4).reshape(b, nc * L, nh, hp)[:, :S]
    return y.to(x.dtype), h


def _ssd_case(b, S, nh, hp, N, dtype, seed):
    """``chip_smoke.py``'s SSD inputs: x unit normals, dt = softplus(z -
    2), A = -exp(z / 2), B and C unit normals over N^(1/4)."""
    rng = np.random.default_rng(seed)

    def z(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))

    x = z(b, S, nh, hp).to(dtype)
    dt = torch.nn.functional.softplus(z(b, S, nh) - 2.0)
    A = -torch.exp(z(nh) * 0.5)
    B, C = ((z(b, S, nh, N) / N ** 0.25).to(dtype) for _ in range(2))
    return x, dt, A, B, C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,S", [(1, 1024), (2, 700)])
def test_ssd_kernel_order_stays_within_the_bars(dtype, b, S):
    """At mamba2-1.3b's widths (hp 64, N 128, chunk 256; 4 of its 64
    heads), the kernel's order of work (serial f32 cumulative sum, fma
    chains in index order) lands within F32_TOL / BF16_TOL of
    ``ssd_chunked`` on the CPU (whose cumulative sum runs in f64 and whose
    products go through the CPU's own GEMMs), its final state within
    F32_TOL."""
    from repro_torch.kernels.ssd_scan import ssd_chunked
    args = _ssd_case(b, S, 4, 64, 128, dtype, seed=S + b)
    want_y, want_h = ssd_chunked(*args, 256)
    y, h = _ssd_kernel_order(*args, 256)
    assert y.dtype == dtype and h.shape == want_h.shape
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert _breaks(y, want_y, tol) == 0
    assert _breaks(h, want_h, F32_TOL) == 0
