"""The precision arguments behind the tensor-core kernels, checked with
torch on the CPU (no card needed).

The bf16 flash body multiplies P (the f32 softmax weights) into V on
bf16 tensor cores, and the int8-weight matmul multiplies f32 x on them.
Both split the f32 operand into bf16 pieces whose products are exact in
f32, so the result differs from the plain f32 version only in summation
order; these tests show that the chosen number of pieces keeps each
kernel within ``chip_smoke.py``'s bar, and that one piece fewer does
not. They also check the exact int8 -> bf16 conversion the matmul
kernel uses. Inputs are drawn with numpy from fixed seeds.
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
