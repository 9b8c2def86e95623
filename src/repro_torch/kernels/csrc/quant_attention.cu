// Split-KV decode attention over an int8 KV cache with per-row scales,
// contiguous and paged.
//
// Replaces: src/repro/kernels/quant.py, quant_decode_attention_splitkv
// (body _quant_decode_kernel) and quant_paged_decode_attention_splitkv
// (body _quant_paged_decode_kernel), each with its merge in the wrapper.
// Payloads are int8 (rows, Hkv, D); one bf16 scale per (row, kv head) in
// ks/vs; a row dequantizes as float(q) * scale in f32, as the reference
// kernels do (quant.py:168-169, 261-264).
//
// Bound on this card: bytes. A valid row costs 2 * (D + 2) bytes of K/V
// payload and scales for 4 * G * D flops (about 1 flop per byte at G = 1,
// D = 64): roughly half the bytes of the bf16 kernels for the same work.
// G is 1 for every served int8 model, far below any tensor-core tile, so
// the design is about memory-level parallelism: wide, coalesced loads,
// all issued before any is used.
//
// Design: one block of 128 threads reduces one split of 128 logical rows
// of one (sequence, kv head) into f32 partials (o, m, l); splitkv.cuh's
// merge_kernel combines the splits with LSE weights and casts on write.
//   * Row metadata: thread t reads logical row t's mask bit and (paged)
//     its page-table entry together, and puts the physical row in shared
//     memory for the lanes; so the 128 rows' lookups are in flight
//     together and no row's are read twice. It then loads the row's two
//     bf16 scales, which only it uses and which arrive under the K and V
//     loads.
//   * Payload: L = D / C lanes share a row, each owning C consecutive
//     columns: C = 16 at G 1 (one 16-byte load per row and tensor), 8 at
//     G 2 and 4 at G > 2, which keeps the G x C accumulators and query
//     values in registers. A warp covers 32 / L rows, the block its split
//     in L passes. Every pass's K and V loads are issued before the first
//     is used; masked rows are never read.
//   * Scores: each lane's C-term dot product with q in f32; the L lanes
//     of a row sum by xor shuffles (offsets L/2 .. 1); thread t then
//     applies row t's K scale and 1/sqrt(D), in that order.
//   * Softmax: thread t owns row t's score, forms the split's max and
//     sum as the bf16 kernels do, and stores p * vs for the P.V pass.
//   * P.V: each lane accumulates (p * vs) * v over its C columns and its
//     L rows; the rows of a warp that share a column slice sum by xor
//     shuffles (offsets 16 .. L), then the 4 warps in shared memory, in
//     warp order.
// Every order above is a function of the logical row index alone, so a
// paged and a contiguous cache holding the same rows give bit-identical
// outputs, and a sequence's output does not depend on its batch. A split
// with no valid row leaves (o, m, l) = (0, NEG_INF, 128), as the bf16
// template does; the merge weights it by exactly 0 whenever the sequence
// has a valid row anywhere.
#include "splitkv.cuh"

namespace {
namespace quant_splitkv {

using splitkv::BK;
constexpr int WARPS = BK / 32;
constexpr unsigned FULL = 0xffffffffu;

// C int8 values at p (C-byte aligned) as C / 4 packed words.
template <int C>
__device__ __forceinline__ void load_words(const int8_t* p, uint32_t* w) {
  if constexpr (C == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (C == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x; w[1] = u.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// Value i of the packed words, as the f32 of its int8.
__device__ __forceinline__ float int8_at(const uint32_t* w, int i) {
  return static_cast<float>(static_cast<int8_t>(w[i >> 2] >> (8 * (i & 3))));
}

template <typename T, int D, int NG, bool PAGED>
__global__ void __launch_bounds__(BK)
quant_split_kernel(const T* __restrict__ q,
                   const splitkv::Rows<int8_t, PAGED> cache,
                   const uint8_t* __restrict__ mask,
                   float* __restrict__ o_part, float* __restrict__ m_part,
                   float* __restrict__ l_part, int G, float sm_scale) {
  // columns a lane owns for a bucket of NG query heads per kv head
  constexpr int C = NG == 1 ? 16 : NG == 2 ? 8 : 4;
  constexpr int L = D / C;     // lanes per row
  constexpr int RP = BK / L;   // rows per pass; L passes cover the split
  constexpr int NW = C / 4;    // packed words per lane and row
  static_assert(L >= 1 && L <= 32 && C % 4 == 0, "lanes per row");
  __shared__ long long srow[BK];  // (row, kv head) index; -1 if masked
  __shared__ float sp[NG][BK];    // lane-summed dot products, then p * vs
  __shared__ float red[NG][WARPS];
  __shared__ float so[WARPS][NG][D];

  const int W = cache.W, Hkv = cache.Hkv;
  const int bh = blockIdx.x;  // b * Hkv + hk
  const int b = bh / Hkv, hk = bh % Hkv;
  const int split = blockIdx.y, ns = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % L, rs = tid / L;  // column slice, row slot

  // row metadata: thread tid reads logical row split * BK + tid's mask bit
  // and table entry together, then its scales, which it alone uses (in the
  // softmax step) and which arrive under the K and V loads below
  long long r = -1;
  float ksc = 0.f, vsc = 0.f;
  {
    const int j = split * BK + tid;
    if (j < W) {
      const bool on = mask[(long long)b * W + j] != 0;
      const long long at = cache.at(b, j, hk);
      if (on) {
        r = at;
        ksc = to_float(cache.ks[r]);
        vsc = to_float(cache.vs[r]);
      }
    }
    srow[tid] = r;
  }
  // this lane's query columns, one row of C per query head
  float qr[NG][C];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int u = 0; u < C; ++u)
      qr[g][u] = (NG == 1 || g < G)
                     ? to_float(q[((long long)bh * G + g) * D + c * C + u])
                     : 0.f;
  }
  __syncthreads();

  // every pass's K and V payloads, all loads in flight together
  uint32_t kw[L][NW], vw[L][NW];
#pragma unroll
  for (int p = 0; p < L; ++p) {
    const long long rp = srow[p * RP + rs];
    if (rp >= 0) {
      load_words<C>(cache.k + rp * D + c * C, kw[p]);
    } else {
#pragma unroll
      for (int i = 0; i < NW; ++i) kw[p][i] = 0u;
    }
  }
#pragma unroll
  for (int p = 0; p < L; ++p) {
    const long long rp = srow[p * RP + rs];
    if (rp >= 0) {
      load_words<C>(cache.v + rp * D + c * C, vw[p]);
    } else {
#pragma unroll
      for (int i = 0; i < NW; ++i) vw[p][i] = 0u;
    }
  }

  // dot products: lane partials, summed across the row's lanes
#pragma unroll
  for (int p = 0; p < L; ++p) {
    const int jj = p * RP + rs;
    float s[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) s[g] = 0.f;
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const float kf = int8_at(kw[p], u);
#pragma unroll
      for (int g = 0; g < NG; ++g) s[g] += qr[g][u] * kf;
    }
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < NG; ++g) s[g] += __shfl_xor_sync(FULL, s[g], off);
    }
    if (c == 0) {
#pragma unroll
      for (int g = 0; g < NG; ++g)
        if (NG == 1 || g < G) sp[g][jj] = s[g];
    }
  }
  __syncthreads();

  // split-local softmax statistics, per query head; thread tid owns row
  // tid and scales its score: the K scale, then 1/sqrt(D)
  float sc[NG], m[NG], l[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    sc[g] = RT_NEG_INF;
    if (NG == 1 || g < G) {
      if (r >= 0) sc[g] = sp[g][tid] * ksc * sm_scale;
      const float w = warp_max(sc[g]);
      if (lane == 0) red[g][warp] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    m[g] = RT_NEG_INF;
    if (NG == 1 || g < G) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) m[g] = fmaxf(m[g], red[g][w]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (NG == 1 || g < G) {
      const float p = expf(sc[g] - m[g]);
      sp[g][tid] = p * vsc;
      const float w = warp_sum(p);
      if (lane == 0) red[g][warp] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    l[g] = 0.f;
    if (NG == 1 || g < G) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) l[g] += red[g][w];
    }
  }

  // o = sum over rows of (p * vs) * v: a masked row has v = 0 and
  // p * vs = 0, so it adds +0 and leaves every sum as it is
  float acc[NG][C];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int u = 0; u < C; ++u) acc[g][u] = 0.f;
  }
#pragma unroll
  for (int p = 0; p < L; ++p) {
    const int jj = p * RP + rs;
    float pv[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) pv[g] = (NG == 1 || g < G) ? sp[g][jj] : 0.f;
#pragma unroll
    for (int u = 0; u < C; ++u) {
      const float vf = int8_at(vw[p], u);
#pragma unroll
      for (int g = 0; g < NG; ++g) acc[g][u] += pv[g] * vf;
    }
  }
#pragma unroll
  for (int off = 16; off >= L; off >>= 1) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
#pragma unroll
      for (int u = 0; u < C; ++u)
        acc[g][u] += __shfl_xor_sync(FULL, acc[g][u], off);
    }
  }
  if (lane < L) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (NG == 1 || g < G) {
#pragma unroll
        for (int u = 0; u < C; ++u) so[warp][g][c * C + u] = acc[g][u];
      }
    }
  }
  __syncthreads();

  const long long base = (long long)bh * ns + split;
  for (int e = tid; e < G * D; e += BK) {
    const int g = e / D, d = e % D;
    float t = so[0][g][d];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) t += so[w][g][d];
    o_part[base * G * D + e] = t;
  }
  if (tid == 0) {
    for (int g = 0; g < G; ++g) {
      m_part[base * G + g] = m[g];
      l_part[base * G + g] = l[g];
    }
  }
}

template <typename T, bool PAGED, int D, int NG>
int launch_g(const void* q, const splitkv::Rows<int8_t, PAGED>& rows,
             const void* mask, float* o_part, float* m_part, float* l_part,
             void* out, int B, int G, cudaStream_t stream) {
  const int ns = (rows.W + BK - 1) / BK;
  quant_split_kernel<T, D, NG, PAGED>
      <<<dim3((unsigned)(B * rows.Hkv), (unsigned)ns), BK, 0, stream>>>(
          static_cast<const T*>(q), rows,
          static_cast<const uint8_t*>(mask), o_part, m_part, l_part, G,
          1.0f / sqrtf((float)D));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return splitkv::launch_merge<T>(o_part, m_part, l_part, out,
                                  B * rows.Hkv, ns, G, D, stream);
}

template <typename T, bool PAGED, int D>
int launch_d(const void* q, const splitkv::Rows<int8_t, PAGED>& rows,
             const void* mask, float* op, float* mp, float* lp, void* out,
             int B, int G, cudaStream_t s) {
  if (G == 1) return launch_g<T, PAGED, D, 1>(q, rows, mask, op, mp, lp, out, B, G, s);
  if (G == 2) return launch_g<T, PAGED, D, 2>(q, rows, mask, op, mp, lp, out, B, G, s);
  if (G <= 4) return launch_g<T, PAGED, D, 4>(q, rows, mask, op, mp, lp, out, B, G, s);
  return launch_g<T, PAGED, D, 8>(q, rows, mask, op, mp, lp, out, B, G, s);
}

// Split + merge for q/out of type T over an int8 cache. For a contiguous
// cache W is its length and ps, NP are unused; for a paged one W = NP * ps
// logical rows.
template <typename T, bool PAGED>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* pt, const void* mask, void* o_part,
           void* m_part, void* l_part, void* out, int B, int W, int Hkv,
           int G, int D, int ps, int NP, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  if (G < 1 || G > splitkv::MAXG)
    return static_cast<int>(cudaErrorInvalidValue);
  const splitkv::Rows<int8_t, PAGED> rows{
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(pt),
      W, Hkv, ps, NP};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  switch (D) {
    case 16: return launch_d<T, PAGED, 16>(q, rows, mask, op, mp, lp, out, B, G, s);
    case 32: return launch_d<T, PAGED, 32>(q, rows, mask, op, mp, lp, out, B, G, s);
    case 64: return launch_d<T, PAGED, 64>(q, rows, mask, op, mp, lp, out, B, G, s);
    case 128: return launch_d<T, PAGED, 128>(q, rows, mask, op, mp, lp, out, B, G, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace quant_splitkv
}  // namespace

extern "C" int rt_quant_decode_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* mask, void* o_part, void* m_part,
    void* l_part, void* out, int B, int W, int Hkv, int G, int D, int dtype,
    void* stream) {
  if (dtype == RT_BF16)
    return quant_splitkv::launch<__nv_bfloat16, false>(
        q, k, v, ks, vs, nullptr, mask, o_part, m_part, l_part, out, B, W,
        Hkv, G, D, 0, 0, stream);
  if (dtype == RT_F32)
    return quant_splitkv::launch<float, false>(
        q, k, v, ks, vs, nullptr, mask, o_part, m_part, l_part, out, B, W,
        Hkv, G, D, 0, 0, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rt_quant_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* ks,
    const void* vs, const void* page_table, const void* mask, void* o_part,
    void* m_part, void* l_part, void* out, int B, int NP, int ps, int Hkv,
    int G, int D, int dtype, void* stream) {
  if (ps <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == RT_BF16)
    return quant_splitkv::launch<__nv_bfloat16, true>(
        q, k_pages, v_pages, ks, vs, page_table, mask, o_part, m_part,
        l_part, out, B, NP * ps, Hkv, G, D, ps, NP, stream);
  if (dtype == RT_F32)
    return quant_splitkv::launch<float, true>(
        q, k_pages, v_pages, ks, vs, page_table, mask, o_part, m_part,
        l_part, out, B, NP * ps, Hkv, G, D, ps, NP, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
