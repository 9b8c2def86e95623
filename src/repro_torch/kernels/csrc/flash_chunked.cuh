// Flash prefill at head dim 80 (zamba2-2.7b) in the plain version's
// order, included by flash_attention.cu for D 80 in both dtypes.
//
// Replaces, at D 80: src/repro/kernels/flash_attention.py,
// flash_attention_fwd, as the other two bodies of flash_attention.cu do.
//
// Why a body of its own: zamba2-2.7b's 54 random-weight Mamba-2 layers
// carry any rounding difference in its 9 shared attention blocks to the
// logits. flash_attention_plain against itself, chunk 256 against 512
// (its f32 sums in another order, nothing else), moved full-depth bf16
// logits by 0.318 against the 0.25 bar (bench/logit_sensitivity.py on
// an H100, PERF.md). A kernel that
// is right to one ulp cannot meet that bar; one equal to the plain
// version bit for bit does. So this body computes what
// flash_attention_plain computes, op for op, each product and sum rounded
// apart as PyTorch's separate kernels round them:
//   for each chunk of `chunk` keys (the plain version's loop):
//     s = q . k, one fma chain over d in index order (cuBLAS's f32
//         GEMM order), times scale; masked keys -1e30;
//     m_new = max(m, max s); p = exp(s - m_new); alpha = exp(m - m_new);
//     l = l * alpha + sum(p), the sum in ATen's reduction order (below);
//     acc = acc * alpha + p . v, one fma chain over the chunk's keys in
//         index order;
//   out = acc / max(l, 1e-30), rounded once to T.
// The sum is PyTorch's CUDA reduction (ATen Reduce.cuh) of p, R = B * Hq
// * S rows of n keys, over its last dim: `lanes` threads a row
// (set_block_dimension: at most 32 once R >= 16), each summing its share
// into 4 accumulators (vectors of 4 when n >= 128, else 4 values strided
// by `lanes`), then (((a0 + a1) + a2) + a3) and a shuffle-down tree with
// offsets lanes / 2 .. 1 (aten_row_sum). A masked key has p = 0 and adds
// nothing, so masked keys, and key tiles and chunks masked for every
// row of a block, are skipped. On the card (torch 2.11) the output
// equals the plain version's bit for bit at every R >= 16 tried, G 1-4,
// windows, chunks of 64-512, n % 4 != 0 (tests/test_torch_cuda.py);
// below 16 rows PyTorch gives a row more than 32 threads, which this
// body does not copy, and it holds the one-ulp bar.
//
// Bound on this card: operations, as for the other bodies; this one runs
// on the f32 CUDA cores, and every product of a chain waits for the one
// before it, so it is several times slower than the tensor-core body
// (times in PERF.md). One block of 256 threads per (b * Hq + h, 32 query
// rows): the block's Q rows and a chunk's scores (then p) in shared
// memory, K and V through one 32-key tile; warp w keeps rows w + 8i's
// statistics, thread t accumulates row t / 8's columns t % 8 + 8u.
#pragma once

#include "common.cuh"

namespace {
namespace chunked {

constexpr int QR = 32;                 // query rows a block
constexpr int KT = 32;                 // keys a tile
constexpr int THREADS = 256;           // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int CG = THREADS / QR;       // column groups of a row
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int last_pow2(long long n) {
  int p = 1;
  while ((long long)p * 2 <= n) p *= 2;
  return p;
}

// Threads a row of ATen's reduction of R rows of n float values over the
// last dim (Reduce.cuh setReduceConfig and set_block_dimension, 512
// threads a block); the emulation below takes at most 32.
__host__ __device__ inline int aten_lanes(long long R, int n) {
  const long long dim0 = n >= 128 ? n / 4 : n;   // vectorized input
  const int d0 = dim0 < 512 ? last_pow2(dim0) : 512;
  const int d1 = R < 512 ? last_pow2(R) : 512;
  int bw = d0 < 32 ? d0 : 32;
  const int bh = d1 < 512 / bw ? d1 : 512 / bw;
  bw = d0 < 512 / bh ? d0 : 512 / bh;
  return bw < 32 ? bw : 32;
}

// The sum of one row's n values get(j) as ATen sums it with `lanes`
// threads; the row starts `shift` floats past a 16-byte boundary. Every
// lane of the warp calls it; lane 0 gets the sum.
template <typename Get>
__device__ __forceinline__ float aten_row_sum(Get get, int n, int shift,
                                              int lanes, int lane) {
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  if (lane < lanes) {
    if (n >= 128) {               // input_vectorized_thread_reduce_impl
      int base = 0, end = n;
      if (shift > 0) {            // the unaligned head, one value a lane
        if (lane >= shift && lane < 4) a[0] = get(lane - shift);
        base = 4 - shift;
        end = n - base;
      }
      for (int idx = lane; idx * 4 + 3 < end; idx += lanes) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = __fadd_rn(a[i], get(base + idx * 4 + i));
      }
      const int t = end - end % 4 + lane;
      if (t < end) a[0] = __fadd_rn(a[0], get(base + t));
    } else {                      // thread_reduce_impl, vt0 4
      int idx = lane;
      for (; idx + 3 * lanes < n; idx += 4 * lanes) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = __fadd_rn(a[i], get(idx + i * lanes));
      }
#pragma unroll
      for (int i = 0; i < 4 && idx < n; ++i, idx += lanes)
        a[i] = __fadd_rn(a[i], get(idx));
    }
  }
  float s = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
  for (int off = lanes / 2; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(FULL, s, off));
  return s;
}

// Keys [lo, hi] of chunk [c0, c0 + n) that query position qi attends.
__device__ __forceinline__ void key_range(int qi, int c0, int n, int causal,
                                          int window, int& lo, int& hi) {
  lo = c0;
  hi = c0 + n - 1;
  if (causal && hi > qi) hi = qi;
  if (window && lo < qi - window + 1) lo = qi - window + 1;
}

// `rows` rows of D values of a (.., Hkv, D) or (.., Hq, D) tensor into
// shared memory as f32, row r at dst + r * pitch; rows past `rows` read 0.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                      long long row_stride, int rows,
                                      int cap) {
  for (int e = threadIdx.x; e < cap * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * pitch + c] = r < rows ? to_float(src[r * row_stride + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_chunked(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int S, int Tn,
                  int Hq, int Hkv, float scale, int causal, int window,
                  int chunk, int lanes_full, int lanes_last) {
  constexpr int DP = D + 1;                     // padded K/V tile row
  constexpr int NC = (D + CG - 1) / CG;         // columns a thread
  extern __shared__ float smem[];
  const int SP = chunk + 1;                     // padded score row
  float* sQ = smem;                             // QR x D
  float* sS = sQ + QR * D;                      // QR x SP: s, then p
  float* sT = sS + QR * SP;                     // KT x DP: a K or V tile
  float* sA = sT + KT * DP;                     // QR: the chunk's alpha
  float* sL = sA + QR;                          // QR: l at the end

  const int bh = blockIdx.x;
  const int h = bh % Hq, hk = h / (Hq / Hkv), b = bh / Hq;
  const int q0 = blockIdx.y * QR;
  const int rows = S - q0 < QR ? S - q0 : QR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long qs = (long long)Hq * D, ks = (long long)Hkv * D;
  const T* kb = k + ((long long)b * Tn * Hkv + hk) * D;
  const T* vb = v + ((long long)b * Tn * Hkv + hk) * D;
  stage<T, D>(sQ, D, q + ((long long)b * S * Hq + (long long)q0 * Hq + h) * D,
              qs, rows, QR);

  const int pr = tid / CG, cg = tid % CG;       // P.V: row, column group
  float acc[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u) acc[u] = 0.f;
  float mw[QR / WARPS], lw[QR / WARPS];         // rows warp + WARPS * i
#pragma unroll
  for (int i = 0; i < QR / WARPS; ++i) {
    mw[i] = RT_NEG_INF;
    lw[i] = 0.f;
  }
  const int qlast = q0 + rows - 1;
  for (int c0 = 0; c0 < Tn; c0 += chunk) {
    const int n = Tn - c0 < chunk ? Tn - c0 : chunk;
    // the chunk's keys some row of the block attends: up to the last
    // row's (causal), from the first row's (window)
    int klo = c0, khi = c0 + n - 1;
    if (causal && khi > qlast) khi = qlast;
    if (window && klo < q0 - window + 1) klo = q0 - window + 1;
    if (klo > khi) continue;      // masked for every row: state unchanged

    // scores s = (q . k) * scale of the attended keys, tile by tile
    for (int t0 = klo; t0 <= khi; t0 += KT) {
      __syncthreads();
      stage<T, D>(sT, DP, kb + (long long)t0 * ks, ks, khi - t0 + 1, KT);
      __syncthreads();
      const int j = t0 + lane;
#pragma unroll
      for (int i = 0; i < QR / WARPS; ++i) {
        const int r = warp + WARPS * i;
        int lo, hi;
        key_range(q0 + r, c0, n, causal, window, lo, hi);
        if (r < rows && j >= lo && j <= hi) {
          float s = 0.f;
#pragma unroll 16
          for (int d = 0; d < D; ++d)
            s = __fmaf_rn(sQ[r * D + d], sT[lane * DP + d], s);
          sS[r * SP + (j - c0)] = __fmul_rn(s, scale);
        }
      }
    }
    __syncthreads();

    // statistics, a warp a row: m, p = exp(s - m_new), l
    const int lanes = n == chunk ? lanes_full : lanes_last;
#pragma unroll
    for (int i = 0; i < QR / WARPS; ++i) {
      const int r = warp + WARPS * i;
      if (r >= rows) continue;
      int lo, hi;
      key_range(q0 + r, c0, n, causal, window, lo, hi);
      float* row = sS + r * SP - c0;
      float mx = RT_NEG_INF;
      for (int j = lo + lane; j <= hi; j += 32) mx = fmaxf(mx, row[j]);
      const float m_new = fmaxf(mw[i], warp_max(mx));
      for (int j = lo + lane; j <= hi; j += 32)
        row[j] = expf(__fsub_rn(row[j], m_new));
      __syncwarp();
      const long long rr = (long long)bh * S + q0 + r;   // p's row
      const float psum = __shfl_sync(FULL, aten_row_sum(
          [&](int jj) {
            const int j = c0 + jj;
            return j >= lo && j <= hi ? row[j] : 0.f;
          }, n, (int)((rr * n) % 4), lanes, lane), 0);
      const float alpha = expf(__fsub_rn(mw[i], m_new));
      lw[i] = __fadd_rn(__fmul_rn(lw[i], alpha), psum);
      mw[i] = m_new;
      if (lane == 0) sA[r] = alpha;
    }

    // p . v over the attended keys in index order, V tile by tile
    float pv[NC];
#pragma unroll
    for (int u = 0; u < NC; ++u) pv[u] = 0.f;
    int plo, phi;
    key_range(q0 + pr, c0, n, causal, window, plo, phi);
    for (int t0 = klo; t0 <= khi; t0 += KT) {
      __syncthreads();
      stage<T, D>(sT, DP, vb + (long long)t0 * ks, ks, khi - t0 + 1, KT);
      __syncthreads();
      if (pr < rows) {
        const int jb = t0 > plo ? t0 : plo;
        const int je = t0 + KT - 1 < phi ? t0 + KT - 1 : phi;
        for (int j = jb; j <= je; ++j) {
          const float p = sS[pr * SP + (j - c0)];
          const float* vr = sT + (j - t0) * DP + cg;
#pragma unroll
          for (int u = 0; u < NC; ++u)
            if (cg + CG * u < D) pv[u] = __fmaf_rn(p, vr[CG * u], pv[u]);
        }
      }
    }
    if (pr < rows) {
      const float alpha = sA[pr];
#pragma unroll
      for (int u = 0; u < NC; ++u)
        acc[u] = __fadd_rn(__fmul_rn(acc[u], alpha), pv[u]);
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < QR / WARPS; ++i) sL[warp + WARPS * i] = lw[i];
  }
  __syncthreads();
  if (pr >= rows) return;
  const float den = fmaxf(sL[pr], 1e-30f);
  T* orow = o + (((long long)b * S + q0 + pr) * Hq + h) * D;
#pragma unroll
  for (int u = 0; u < NC; ++u)
    if (cg + CG * u < D)
      orow[cg + CG * u] = from_float<T>(__fdiv_rn(acc[u], den));
}

// Launches the body for q (B, S, Hq, D), k/v (B, Tn, Hkv, D) with the
// plain version's chunk (capped at Tn, as it caps it).
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tn, int Hq, int Hkv, int causal, int window, int chunk,
           cudaStream_t stream) {
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (chunk > Tn) chunk = Tn;
  const size_t smem = sizeof(float) *
      ((size_t)QR * D + (size_t)QR * (chunk + 1) + KT * (D + 1) + 2 * QR);
  auto kern = flash_fwd_chunked<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long R = (long long)B * Hq * S;     // rows of the plain p
  const int last = Tn % chunk ? Tn % chunk : chunk;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((S + QR - 1) / QR));
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tn, Hq, Hkv,
      (float)(1.0 / sqrt((double)D)), causal, window, chunk,
      aten_lanes(R, chunk), aten_lanes(R, last));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chunked
}  // namespace
