// Split-KV decode attention (flash-decoding) for Hopper.
//
// Replaces: src/repro/kernels/decode_attention.py,
// decode_attention_splitkv (body _decode_kernel, merge in the wrapper):
// one query token per sequence against a contiguous cache, each split of
// the cache reduced into f32 partials (o, m, l), then an LSE-weighted
// merge across splits.
//
// Layouts are the reference's: q (B, Hq, D), k/v caches (B, W, Hkv, D),
// mask (B, W) bool, out (B, Hq, D). Hq = Hkv * G; the G query heads of
// one kv head share each key and value row read.
//
// Bound on this card: bytes. Each valid cache row is read once for
// 4 * G * D flops against 4 * D bytes (bf16), i.e. G flops per byte,
// far below the ridge. Design: grid (B * Hkv, ceil(W / 128)), one
// thread per cache row in a split, so the whole cache is streamed by
// ~B * Hkv * W / 128 blocks in parallel (576 blocks at B = 4, W = 1024,
// Hkv = 36); rows are read with 16-byte vector loads, masked rows are
// not read at all, and a V row is skipped when its weight is 0. A
// second small kernel merges the per-split partials, as the reference
// wrapper does (decode_attention.py:88-96), and casts on write.
#include "common.cuh"

namespace {

constexpr int BK = 128;   // cache rows per split == threads per block
constexpr int MAXG = 8;   // query heads per kv head

template <typename T, int D>
__global__ void __launch_bounds__(BK)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc,
                    const uint8_t* __restrict__ mask,
                    float* __restrict__ o_part, float* __restrict__ m_part,
                    float* __restrict__ l_part, int W, int Hkv, int G,
                    float sm_scale) {
  __shared__ float sq[MAXG * D];
  __shared__ float sp[MAXG][BK];
  __shared__ float red[MAXG][BK / 32];
  __shared__ float so[BK / D > 1 ? BK / D : 1][MAXG][D];

  const int bh = blockIdx.x;  // b * Hkv + hk
  const int b = bh / Hkv, hk = bh % Hkv;
  const int split = blockIdx.y, ns = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < G * D; e += BK)
    sq[e] = to_float(q[((long long)b * Hkv * G + (long long)hk * G) * D + e]);
  __syncthreads();

  // scores: thread tid owns cache row j
  const int j = split * BK + tid;
  const bool valid = j < W && mask[(long long)b * W + j] != 0;
  float s[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
  if (valid) {
    const T* krow = kc + (((long long)b * W + j) * Hkv + hk) * D;
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
      const float vv = to_float(vc[(((long long)b * W + jr) * Hkv + hk) * D + d]);
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
__global__ void decode_merge_kernel(const float* __restrict__ o_part,
                                    const float* __restrict__ m_part,
                                    const float* __restrict__ l_part,
                                    T* __restrict__ out, int ns, int G,
                                    int D) {
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
  out[((long long)bh * G + g) * D + d] = from_float<T>(acc / fmaxf(l_all, 1e-30f));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask,
           float* o_part, float* m_part, float* l_part, void* out, int B,
           int W, int Hkv, int G, cudaStream_t stream) {
  const int ns = (W + BK - 1) / BK;
  decode_split_kernel<T, D><<<dim3((unsigned)(B * Hkv), (unsigned)ns), BK, 0,
                              stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(mask), o_part,
      m_part, l_part, W, Hkv, G, 1.0f / sqrtf((float)D));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_merge_kernel<T><<<dim3((unsigned)(B * Hkv), (unsigned)G), D, 0,
                           stream>>>(o_part, m_part, l_part,
                                     static_cast<T*>(out), ns, G, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* mask,
             float* o_part, float* m_part, float* l_part, void* out, int B,
             int W, int Hkv, int G, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, mask, o_part, m_part, l_part, out, B, W, Hkv, G, stream);
    case 32: return launch<T, 32>(q, k, v, mask, o_part, m_part, l_part, out, B, W, Hkv, G, stream);
    case 64: return launch<T, 64>(q, k, v, mask, o_part, m_part, l_part, out, B, W, Hkv, G, stream);
    case 128: return launch<T, 128>(q, k, v, mask, o_part, m_part, l_part, out, B, W, Hkv, G, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int rt_decode_attention(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   void* o_part, void* m_part, void* l_part,
                                   void* out, int B, int W, int Hkv, int G,
                                   int D, int dtype, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (G < 1 || G > MAXG) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  if (dtype == RT_BF16)
    return launch_d<__nv_bfloat16>(q, k, v, mask, op, mp, lp, out, B, W, Hkv,
                                   G, D, s);
  if (dtype == RT_F32)
    return launch_d<float>(q, k, v, mask, op, mp, lp, out, B, W, Hkv, G, D,
                           s);
  return static_cast<int>(cudaErrorInvalidValue);
}
