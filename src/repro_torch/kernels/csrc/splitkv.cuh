// Split-KV decode attention (flash-decoding) for Hopper: the split kernel
// of the bf16/f32 decode pair and the merge kernel shared by every decode
// variant of the port.
//
// One query token per sequence against a cache of W logical rows per
// sequence; each split of BK logical rows is reduced into f32 partials
// (o, m, l), then a second small kernel merges the splits with LSE
// weights and casts on write, as the reference wrappers do
// (decode_attention.py:88-96, paged_attention.py:121-129).
//
// split_kernel varies only in how a row is found:
//   * KT: the stored type, float / bf16 (the int8 cache has a body of its
//     own in quant_attention.cu, on the same Rows and merge_kernel);
//   * PAGED: logical row j of sequence b lives at physical page
//     pt[b, j / ps], row j % ps, of a (P, ps, Hkv, D) pool; the block
//     reads the page table itself.
// The split of logical rows (BK per split) and every sum are the same
// for both variants, so a paged cache and a contiguous one holding the
// same rows give bit-identical outputs.
//
// Layouts are the reference's: q (B, Hq, D), contiguous caches
// (B, W, Hkv, D), pools (P, ps, Hkv, D), int8 scales without the last
// axis, page table (B, NP) int32, mask (B, W) bool, out (B, Hq, D).
// Hq = Hkv * G; the G query heads of one kv head share each key and value
// row read.
#pragma once

#include "common.cuh"

namespace {
namespace splitkv {

constexpr int BK = 128;   // logical rows per split == threads per block
constexpr int MAXG = 8;   // query heads per kv head

// Where the cache rows live and how they are stored.
template <typename KT, bool PAGED>
struct Rows {
  const KT* k;
  const KT* v;
  const __nv_bfloat16* ks;  // (rows, Hkv) scales, int8 only
  const __nv_bfloat16* vs;
  const int* pt;            // (B, NP) physical pages, paged only
  int W;                    // logical rows per sequence
  int Hkv;
  int ps;                   // page size, paged only
  int NP;                   // pages per sequence, paged only

  // index of logical row j of sequence b among the (row, kv head) pairs
  // of the cache, for kv head hk
  __device__ __forceinline__ long long at(int b, int j, int hk) const {
    long long r;
    if constexpr (PAGED)
      r = (long long)pt[(long long)b * NP + j / ps] * ps + j % ps;
    else
      r = (long long)b * W + j;
    return r * Hkv + hk;
  }
};

template <typename T, typename KT, int D, bool PAGED>
__global__ void __launch_bounds__(BK)
split_kernel(const T* __restrict__ q, const Rows<KT, PAGED> cache,
             const uint8_t* __restrict__ mask, float* __restrict__ o_part,
             float* __restrict__ m_part, float* __restrict__ l_part, int G,
             float sm_scale) {
  // In a split with no valid row every weight is exp(0) = 1. The
  // contiguous kernel then reads those V rows, as the reference does;
  // the paged variant never reads a masked row. The merge weights such a
  // split by exactly 0 whenever the sequence has a valid row anywhere, so
  // both give the same outputs on every such sequence.
  constexpr bool SKIP_MASKED = PAGED;
  __shared__ float sq[MAXG * D];
  __shared__ float sp[MAXG][BK];
  __shared__ float red[MAXG][BK / 32];
  __shared__ float so[BK / D > 1 ? BK / D : 1][MAXG][D];

  const int W = cache.W, Hkv = cache.Hkv;
  const int bh = blockIdx.x;  // b * Hkv + hk
  const int b = bh / Hkv, hk = bh % Hkv;
  const int split = blockIdx.y, ns = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < G * D; e += BK)
    sq[e] = to_float(q[((long long)b * Hkv * G + (long long)hk * G) * D + e]);
  __syncthreads();

  // scores: thread tid owns logical row j
  const int j = split * BK + tid;
  const bool valid = j < W && mask[(long long)b * W + j] != 0;
  float s[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
  if (valid) {
    const long long r = cache.at(b, j, hk);
    const KT* krow = cache.k + r * D;
#pragma unroll
    for (int c = 0; c < D; c += 8) {
      float kv[8];
      load8(krow + c, kv);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
#pragma unroll
          for (int u = 0; u < 8; ++u) s[g] += sq[g * D + c + u] * kv[u];
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < MAXG; ++g) s[g] = valid ? s[g] * sm_scale : RT_NEG_INF;

  // split-local softmax statistics, per query head
  float m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      const float w = warp_max(s[g]);
      if (lane == 0) red[g][warp] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = RT_NEG_INF;
    if (g < G) {
#pragma unroll
      for (int w = 0; w < BK / 32; ++w) m[g] = fmaxf(m[g], red[g][w]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      const float p = expf(s[g] - m[g]);
      sp[g][tid] = p;
      const float w = warp_sum(p);
      if (lane == 0) red[g][warp] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    l[g] = 0.f;
    if (g < G) {
#pragma unroll
      for (int w = 0; w < BK / 32; ++w) l[g] += red[g][w];
    }
  }

  // o = p @ v over this split: column d, rows part, part + NPART, ...
  constexpr int NPART = BK / D > 1 ? BK / D : 1;
  const int d = tid % D, part = tid / D;
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
  if (part < NPART) {
    for (int jj = part; jj < BK; jj += NPART) {
      const int jr = split * BK + jj;
      if (jr >= W) break;
      bool any = false;
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) any = any || sp[g][jj] != 0.f;
      if (!any) continue;
      if constexpr (SKIP_MASKED) {
        if (!mask[(long long)b * W + jr]) continue;
      }
      const long long r = cache.at(b, jr, hk);
      const float vv = to_float(cache.v[r * D + d]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] += sp[g][jj] * vv;
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) so[part][g][d] = acc[g];
  }
  __syncthreads();

  const long long base = (long long)bh * ns + split;
  if (tid < D) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float t = 0.f;
        for (int pp = 0; pp < NPART; ++pp) t += so[pp][g][tid];
        o_part[(base * G + g) * D + tid] = t;
      }
    }
  }
  if (tid == 0) {
    for (int g = 0; g < G; ++g) {
      m_part[base * G + g] = m[g];
      l_part[base * G + g] = l[g];
    }
  }
}

// One block per (b * Hkv + hk, g), one thread per head-dim column.
template <typename T>
__global__ void merge_kernel(const float* __restrict__ o_part,
                             const float* __restrict__ m_part,
                             const float* __restrict__ l_part,
                             T* __restrict__ out, int ns, int G, int D) {
  const int bh = blockIdx.x, g = blockIdx.y, d = threadIdx.x;
  float m_all = RT_NEG_INF;
  for (int s = 0; s < ns; ++s)
    m_all = fmaxf(m_all, m_part[((long long)bh * ns + s) * G + g]);
  float l_all = 0.f, acc = 0.f;
  for (int s = 0; s < ns; ++s) {
    const long long i = ((long long)bh * ns + s) * G + g;
    const float w = expf(m_part[i] - m_all);
    l_all += l_part[i] * w;
    acc += o_part[i * D + d] * w;
  }
  out[((long long)bh * G + g) * D + d] =
      from_float<T>(acc / fmaxf(l_all, 1e-30f));
}

// The merge of ns splits' partials for BH = B * Hkv (sequence, kv head)
// pairs into out.
template <typename T>
int launch_merge(const float* o_part, const float* m_part,
                 const float* l_part, void* out, int BH, int ns, int G,
                 int D, cudaStream_t stream) {
  merge_kernel<T><<<dim3((unsigned)BH, (unsigned)G), D, 0, stream>>>(
      o_part, m_part, l_part, static_cast<T*>(out), ns, G, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KT, bool PAGED, int D>
int launch_d(const void* q, const Rows<KT, PAGED>& rows, const void* mask,
             float* o_part, float* m_part, float* l_part, void* out, int B,
             int G, cudaStream_t stream) {
  const int ns = (rows.W + BK - 1) / BK;
  split_kernel<T, KT, D, PAGED>
      <<<dim3((unsigned)(B * rows.Hkv), (unsigned)ns), BK, 0, stream>>>(
          static_cast<const T*>(q), rows,
          static_cast<const uint8_t*>(mask), o_part, m_part, l_part, G,
          1.0f / sqrtf((float)D));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_merge<T>(o_part, m_part, l_part, out, B * rows.Hkv, ns, G,
                         D, stream);
}

// Split + merge for q/out of type T over a cache stored as KT (float or
// bf16; ks and vs are unused). For a contiguous cache W is its length and
// ps, NP are unused; for a paged one W = NP * ps logical rows.
template <typename T, typename KT, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pt, const void* mask, void* o_part,
           void* m_part, void* l_part, void* out, int B, int W, int Hkv,
           int G, int D, int ps, int NP, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (G < 1 || G > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  const Rows<KT, PAGED> rows{
      static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(pt),
      W, Hkv, ps, NP};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  switch (D) {
    case 16: return launch_d<T, KT, PAGED, 16>(q, rows, mask, op, mp, lp, out, B, G, s);
    case 32: return launch_d<T, KT, PAGED, 32>(q, rows, mask, op, mp, lp, out, B, G, s);
    case 64: return launch_d<T, KT, PAGED, 64>(q, rows, mask, op, mp, lp, out, B, G, s);
    case 128: return launch_d<T, KT, PAGED, 128>(q, rows, mask, op, mp, lp, out, B, G, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace splitkv
}  // namespace
