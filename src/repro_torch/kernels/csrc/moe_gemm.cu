// Grouped (ragged) expert GEMM for Hopper.
//
// Replaces: src/repro/kernels/moe_gemm.py, grouped_gemm_padded (body
// _gemm_kernel): rows sorted by expert into blocks of BM rows, each block
// owned by one expert; block i computes x_pad[i*BM:(i+1)*BM] @ w[e_i],
// f32 accumulation, output in x's dtype.
//
// Inputs: x_pad (Tp, d), w (E, d, f), block_expert (nb,) and block_rows
// (nb,) int32, out (Tp, f); all contiguous, Tp = nb * BM, BM = 64 (the
// wrapper's BLOCK_M). block_rows[i]
// is the number of real rows of block i (a prefix of the block). The
// sort's static bound leaves trailing blocks with block_expert == E,
// which names no expert: the Pallas index map clamps it, this kernel
// returns at once for any block without a real row, so it never reads
// past w, never reads a weight tile for padding, and writes only real
// rows (the caller gathers exactly those back).
//
// Bound on this card: bytes at decode, where 16 routed rows touch at
// most 16 experts and the function must read each of their (d, f)
// matrices once (~92 MB at qwen2-moe's widths); operations at a
// 1024-token prefill (4096 rows, ~23.6 GFLOP against ~346 MB). This
// first kernel multiplies on the f32 CUDA cores (no tensor cores yet),
// so it is far from either bound. Design: one block of 256 threads per
// (64-row block, 64-column tile), a K loop over d in 64-deep stages
// through shared memory (x tile stored k-major so a thread's 4 rows are
// one broadcast read, weight tile row-major so its 4 columns are
// neighbours), 4 x 4 outputs per thread in registers. At decode a block
// holds a row or two: all 256 threads stage the weight tile, and only
// the threads that own a real row multiply. A row's sum runs over k in order
// 0..d-1 whatever block or position it lands in, so a row's result does
// not depend on the batch it is sorted with: no split-K, no atomics.
#include "common.cuh"

namespace {

constexpr int BM = 64;         // rows per block
constexpr int BN = 64;         // output columns per block
constexpr int BK = 64;         // reduction depth per shared-memory stage
constexpr int TM = 4, TN = 4;  // outputs per thread (rows x columns)
constexpr int NTX = BN / TN;
constexpr int NT = (BM / TM) * NTX;  // 256 threads

template <typename T>
__global__ void __launch_bounds__(NT)
moe_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const int* __restrict__ block_expert,
                const int* __restrict__ block_rows, T* __restrict__ out,
                int d, int f, int E) {
  const int blk = blockIdx.x;
  const int nrows = block_rows[blk];
  const int e = block_expert[blk];
  if (nrows <= 0 || e < 0 || e >= E) return;  // trailing or empty block

  __shared__ float xs[BK][BM + 4];
  __shared__ float ws[BK][BN + 4];
  const int tid = threadIdx.x, tx = tid % NTX, ty = tid / NTX;
  const int n0 = blockIdx.y * BN;
  const T* xb = x + (long long)blk * BM * d;
  const T* we = w + (long long)e * d * f;
  const bool live = ty * TM < nrows;  // this thread has a real row

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int i = tid; i < BM * BK; i += NT) {
      const int r = i / BK, k = i % BK;
      xs[k][r] = (r < nrows && k0 + k < d)
                     ? to_float(xb[(long long)r * d + k0 + k])
                     : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int k = i / BN, n = i % BN;
      ws[k][n] = (k0 + k < d && n0 + n < f)
                     ? to_float(we[(long long)(k0 + k) * f + n0 + n])
                     : 0.f;
    }
    __syncthreads();
    if (live) {
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = xs[k][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = ws[k][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty * TM + i;
    if (r >= nrows) continue;
    T* orow = out + ((long long)blk * BM + r) * f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < f) orow[n] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* be, const void* rows,
           void* out, int nb, int d, int f, int E, cudaStream_t s) {
  const dim3 grid((unsigned)nb, (unsigned)((f + BN - 1) / BN));
  moe_gemm_kernel<T><<<grid, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(be), static_cast<const int*>(rows),
      static_cast<T*>(out), d, f, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_moe_gemm(const void* x, const void* w,
                           const void* block_expert, const void* block_rows,
                           void* out, int nb, int d, int f, int E, int dtype,
                           void* stream) {
  if (nb <= 0 || f <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_BF16)
    return launch<__nv_bfloat16>(x, w, block_expert, block_rows, out, nb, d,
                                 f, E, s);
  if (dtype == RT_F32)
    return launch<float>(x, w, block_expert, block_rows, out, nb, d, f, E, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
