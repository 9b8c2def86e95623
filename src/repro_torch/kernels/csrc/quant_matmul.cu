// int8-weight matmul for Hopper.
//
// Replaces: src/repro/kernels/quant.py, quant_matmul_pallas (body
// _quant_matmul_kernel): out = (x.f32 @ w_q.f32) * scale[None, :], cast
// to x's dtype once. x (T, K) f32 or bf16, w_q (K, N) int8, scale (N,)
// f32 (one symmetric scale per output column), out (T, N) in x's dtype;
// all contiguous.
//
// Bound on this card: bytes at decode, operations at prefill. At decode
// (T of 1-4 rows) the function must read the whole int8 weight once
// (minicpm-2b's 2304 x 17280 is 39.8 MB, ~12 us at 3.35 TB/s) for ~2 T
// operations per weight byte. At a 32k-token prefill it does 2 T K N
// operations (2.6 TFLOP at minicpm-2b's widths) on ~2.7 GB of x and out,
// and this first kernel multiplies on the f32 CUDA cores (67 TFLOP/s;
// int8 -> bf16 is exact for -127..127, so tensor cores are later work).
//
// Design. The Pallas kernel keeps the whole K of an x row block and a
// weight column block in VMEM; a Hopper block's 227 KB cannot hold them
// (K is 2048-6144 here), so each block owns one (BM x BN) output tile and
// walks K in BK-deep stages through shared memory, with the next stage's
// loads held in registers while the current one is multiplied. Each
// thread loads 16 int8 weights of one row with one 16-byte load along N
// and widens them to f32 in registers on the way into shared memory; x is
// staged k-major so a thread's rows are one broadcast read. Sums are f32,
// in k order 0..K-1. The per-column scale multiplies the f32 accumulator
// once, in the epilogue, and the result is rounded once to x's dtype, as
// the plain version computes. The ragged T, N and K edges are masked
// (zeros in shared memory, no store past the edge): nothing is padded or
// copied. Two tile shapes: 64 x 128 (4 x 8 outputs a thread) for T > 16,
// and 16 x 64 (1 x 4) with 64-deep stages for decode, which gives twice
// the blocks to stream the weight and leaves fewer idle rows: at T 1 and
// 4 it runs 2.4-2.8x (K 2304, N 17280) and 1.6-1.8x (K 6144, N 8192)
// faster than the 64 x 128 tile on an H100 SXM at 700 W
// (python -m repro_torch.bench.quant_matmul, each tile built alone).
#include "common.cuh"

namespace {

constexpr int NT = 256;       // threads per block, 16 x 16
constexpr int NTX = 16;       // threads along N
constexpr int NTY = NT / NTX; // threads along T
constexpr int WVEC = 16;      // int8 weights per 16-byte load

// The b-th int8 of a little-endian word, sign-extended, as float.
__device__ __forceinline__ float byte_to_float(unsigned int word, int b) {
  return static_cast<float>(static_cast<int>(word << (24 - 8 * b)) >> 24);
}

// TM x TN outputs per thread; BK * BN / WVEC == NT, so every thread loads
// one 16-byte run of weights per stage.
template <typename T, int TM, int TN, int BK>
__global__ void __launch_bounds__(NT)
quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, T* __restrict__ out,
                    int n_rows, int K, int N, bool vec) {
  constexpr int BM = NTY * TM, BN = NTX * TN;
  constexpr int XPT = BM * BK / NT;  // x values a thread stages per stage
  static_assert(BK * BN == NT * WVEC, "one weight load per thread");
  static_assert(TN % 4 == 0 && (BM * BK) % NT == 0, "tile shape");
  __shared__ __align__(16) float xs[BK][BM + 4];
  __shared__ __align__(16) float ws[BK][BN + 4];

  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  const long long m0 = (long long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int rows = (int)min((long long)BM, (long long)n_rows - m0);
  const bool live = ty * TM < rows;  // this thread owns a real row
  // this thread's weight run: row wk of the stage, columns wc..wc+15
  const int wk = tid / (BN / WVEC), wc = (tid % (BN / WVEC)) * WVEC;

  float xr[XPT];
  unsigned int wr[WVEC / 4];

  auto load = [&](int k0) {
#pragma unroll
    for (int s = 0; s < XPT; ++s) {
      const int i = tid + s * NT, r = i / BK, k = i % BK;
      xr[s] = (r < rows && k0 + k < K)
                  ? to_float(x[(m0 + r) * K + k0 + k])
                  : 0.f;
    }
    const int kg = k0 + wk, ng = n0 + wc;
    const int8_t* src = w + (long long)kg * N + ng;
    if (kg < K && vec && ng < N) {  // N % 16 == 0: the run is whole
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      wr[0] = v.x; wr[1] = v.y; wr[2] = v.z; wr[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < WVEC / 4; ++q) {
        unsigned int word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int n = ng + 4 * q + b;
          if (kg < K && n < N)
            word |= (unsigned int)(unsigned char)src[4 * q + b] << (8 * b);
        }
        wr[q] = word;
      }
    }
  };

  auto store = [&]() {
#pragma unroll
    for (int s = 0; s < XPT; ++s) {
      const int i = tid + s * NT;
      xs[i % BK][i / BK] = xr[s];
    }
#pragma unroll
    for (int q = 0; q < WVEC / 4; ++q)
      *reinterpret_cast<float4*>(&ws[wk][wc + 4 * q]) =
          make_float4(byte_to_float(wr[q], 0), byte_to_float(wr[q], 1),
                      byte_to_float(wr[q], 2), byte_to_float(wr[q], 3));
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool more = k0 + BK < K;
    if (more) load(k0 + BK);  // in flight while this stage multiplies
    if (live) {
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[k][ty * TM + i];
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(
              &ws[k][tx * TN + 4 * q]);
          b[4 * q] = v.x; b[4 * q + 1] = v.y;
          b[4 * q + 2] = v.z; b[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= rows) continue;
    T* orow = out + (m0 + r) * N;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) orow[n] = from_float<T>(acc[i][j] * scale[n]);
    }
  }
}

template <typename T, int TM, int TN, int BK>
int launch(const void* x, const void* w, const void* scale, void* out,
           int n_rows, int K, int N, cudaStream_t s) {
  constexpr int BM = NTY * TM, BN = NTX * TN;
  const bool vec = N % WVEC == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((unsigned)((N + BN - 1) / BN),
                  (unsigned)((n_rows + BM - 1) / BM));
  quant_matmul_kernel<T, TM, TN, BK><<<grid, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<T*>(out), n_rows, K, N,
      vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_tile(const void* x, const void* w, const void* scale, void* out,
                  int n_rows, int K, int N, cudaStream_t s) {
  if (n_rows <= NTY)  // decode: 16 x 64 tiles, 64-deep stages
    return launch<T, 1, 4, 64>(x, w, scale, out, n_rows, K, N, s);
  return launch<T, 4, 8, 32>(x, w, scale, out, n_rows, K, N, s);
}

}  // namespace

extern "C" int rt_quant_matmul(const void* x, const void* w, const void* scale,
                               void* out, int n_rows, int K, int N, int dtype,
                               void* stream) {
  if (n_rows <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_BF16)
    return dispatch_tile<__nv_bfloat16>(x, w, scale, out, n_rows, K, N, s);
  if (dtype == RT_F32)
    return dispatch_tile<float>(x, w, scale, out, n_rows, K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
