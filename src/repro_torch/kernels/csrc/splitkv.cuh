// Split-KV decode attention (flash-decoding) for Hopper: the row-parallel
// split body shared by every decode variant of the port (bf16/f32 and int8
// caches, contiguous and paged) and the merge kernel after it.
//
// One query token per sequence against a cache of W logical rows per
// sequence; each split of BK logical rows of one (sequence, kv head) is
// reduced by one block into f32 partials (o, m, l), then a second small
// kernel merges the splits with LSE weights and casts on write, as the
// reference wrappers do (decode_attention.py:88-96,
// paged_attention.py:121-129).
//
// Bound on this card: bytes. A valid row costs 2 * D values of K/V for
// 4 * G * D flops, G flops per byte or less (bf16), far below the ridge
// at every served G (1 to 16: chatglm3-6b 16, starcoder2-3b 12,
// qwen2-vl-7b 7, stablelm-12b 4, mixtral-8x22b 6). So the design is about
// memory-level parallelism: wide, coalesced loads, all issued before any
// is used.
//
// split_rows varies in three things:
//   * KT, the stored type: float, bf16, or int8 with one bf16 scale per
//     (row, kv head) in ks / vs; an int8 row dequantizes as
//     float(q) * scale in f32, as the reference kernels do
//     (quant.py:168-169, 261-264);
//   * PAGED: logical row j of sequence b lives at physical page
//     pt[b, j / ps], row j % ps, of a (P, ps, Hkv, D) pool; the block
//     reads the page table itself;
//   * NG, the bucket (1, 2, 4, 8) of the query heads a block computes.
//     A group of G <= 8 query heads per kv head is one block's; past 8
//     (G 12 and 16) the heads split into ceil(G / 8) equal parts, one
//     block each (blockIdx.z), which read the same K/V rows, the second
//     time mostly from L2. A head's arithmetic is the same whichever
//     block computes it, and the grid doubles where Hkv is small
//     (Hkv 2 at G 12 and 16).
// Design:
//   * Row metadata: thread t reads logical row t's mask bit and (paged)
//     its page-table entry together, and puts the physical (row, kv head)
//     index in shared memory, -1 if the row is masked or past W; so the
//     128 rows' lookups are in flight together and no row's are read
//     twice. For int8 it then loads the row's two scales, which only it
//     uses (in the softmax step) and which arrive under the K and V loads.
//   * Lanes: L lanes share a row, the first D / C each owning C
//     consecutive columns: one 16-byte load per row and tensor at G 1
//     (C = 8 for bf16, 4 for f32, 16 for int8); at most 8 columns at G 2
//     and 4 at G > 2, which keeps the G x C accumulators and query values
//     in registers; C doubles while D / C > 32, so a row's lanes fit one
//     warp (D 160: C 8, two 16-byte loads for f32). L is D / C rounded up
//     to a power of two, so that a row's lanes sum by xor shuffles and a
//     pass holds BK / L whole rows: at D 16-128 every lane is live; at
//     D 80 (zamba2-2.7b) 10 of 16 bf16 lanes (5 of 8 int8, 20 of 32 f32)
//     and at D 160 (stablelm-12b) 20 of 32 (10 of 16 int8 at G 1), the
//     others idle, reading nothing and adding exact zeros. A warp covers
//     32 / L rows, the block its split in L passes.
//   * Loads before use: every pass's K loads are issued before the first
//     is used. V loads go with them while both fit in 64 registers a
//     thread (int8 always; bf16 to D 64; f32 to D 32); past that the
//     passes are staged: K for all passes, the dot products, then V into
//     the registers K held, before the softmax's barriers, so V arrives
//     under them. Where one tensor's passes would take more than 128
//     registers (f32 at D 160), they go in groups of 64 registers: K
//     group by group, each group's dot products before the next loads;
//     V's first group before the softmax, the rest in the P.V pass. The
//     passes keep their order, so the sums do not change. Masked rows
//     are never read.
//   * Scores: each lane's C-term dot product with q in f32; the L lanes
//     of a row sum by xor shuffles (offsets L/2 .. 1); thread t then
//     applies row t's K scale (int8) and 1/sqrt(D), in that order.
//   * Softmax: thread t owns row t's score and forms the split's max and
//     sum per query head (warp reduce, then the 4 warps in order); it
//     stores p (times the V scale, int8) for the P.V pass.
//   * P.V: each lane accumulates p * v over its C columns and its L rows;
//     the rows of a warp that share a column slice sum by xor shuffles
//     (offsets 16 .. L), then the 4 warps in shared memory, in warp order.
// Every order above is a function of the logical row index alone, so a
// paged and a contiguous cache holding the same rows give bit-identical
// outputs, and a sequence's output does not depend on its batch.
//
// Masked rows score RT_NEG_INF. A split with no valid row leaves
// (o, m, l) = (0, NEG_INF, 128); the merge weights it by exactly 0
// whenever the sequence has a valid row anywhere. A wholly masked
// sequence comes out 0. The reference's own two paths disagree there:
// its xla path gives the mean of V over W, its Pallas wrapper divides
// by the count padded to a split multiple; decode never builds one.
//
// Layouts are the reference's: q (B, Hq, D), contiguous caches
// (B, W, Hkv, D), pools (P, ps, Hkv, D), int8 scales without the last
// axis, page table (B, NP) int32, mask (B, W) bool, out (B, Hq, D).
// Hq = Hkv * G; the G query heads of one kv head share each key and value
// row read.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "plan.cuh"

namespace {
namespace splitkv {

constexpr int BK = 128;   // logical rows per split == threads per block
constexpr int MAXG = 8;   // query heads a block
constexpr int MAX_GROUP = 16;  // query heads per kv head
constexpr int WARPS = BK / 32;
constexpr unsigned FULL = 0xffffffffu;

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

// Columns a lane owns for a bucket of NG query heads a block at head dim
// D: one 16-byte load's worth, capped by NG, then doubled while a row
// would need more than a warp's lanes.
template <typename KT, int NG, int D>
__host__ __device__ constexpr int lane_cols() {
  constexpr int c16 = 16 / (int)sizeof(KT);
  constexpr int cap = NG == 1 ? 16 : NG == 2 ? 8 : 4;
  int c = c16 < cap ? c16 : cap;
  while (D / c > 32) c *= 2;
  return c;
}

// BYTES bytes at p (BYTES-aligned) as BYTES / 4 words.
template <int BYTES>
__device__ __forceinline__ void load_words(const void* p, uint32_t* w) {
  if constexpr (BYTES == 32) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    w[4] = t.x; w[5] = t.y; w[6] = t.z; w[7] = t.w;
  } else if constexpr (BYTES == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else if constexpr (BYTES == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = u.x; w[1] = u.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// Value i of packed words of KT, as f32.
template <typename KT>
__device__ __forceinline__ float unpack(const uint32_t* w, int i);
template <>
__device__ __forceinline__ float unpack<int8_t>(const uint32_t* w, int i) {
  return static_cast<float>(static_cast<int8_t>(w[i >> 2] >> (8 * (i & 3))));
}
template <>
__device__ __forceinline__ float unpack<__nv_bfloat16>(const uint32_t* w,
                                                       int i) {
  const uint32_t x = w[i >> 1];
  return __uint_as_float((i & 1) ? (x & 0xffff0000u) : (x << 16));
}
template <>
__device__ __forceinline__ float unpack<float>(const uint32_t* w, int i) {
  return __uint_as_float(w[i]);
}

// Lanes a row for a head dim of D at C columns a lane: D / C rounded up
// to a power of two.
template <int D, int C>
__host__ __device__ constexpr int row_lanes() {
  int l = 1;
  while (l < D / C) l *= 2;
  return l;
}

// This lane's C columns of the rows of passes p0 .. p0 + PG - 1 of one
// tensor (row slot rs of pass p is row p * RP + rs of the split, RP =
// BK / L); masked rows, and every row of an idle lane (live false), read
// as zeros.
template <int D, int C, int L, typename KT, int PG, int NW>
__device__ __forceinline__ void load_passes(const KT* __restrict__ base,
                                            const long long* srow, int rs,
                                            int c, bool live, int p0,
                                            uint32_t (&w)[PG][NW]) {
  constexpr int RP = BK / L;
#pragma unroll
  for (int p = 0; p < PG; ++p) {
    const long long rp = srow[(p0 + p) * RP + rs];
    if (rp >= 0 && live) {
      load_words<NW * 4>(base + rp * D + c * C, w[p]);
    } else {
#pragma unroll
      for (int i = 0; i < NW; ++i) w[p][i] = 0u;
    }
  }
}

// One block: split blockIdx.y of (sequence, kv head) blockIdx.x, for
// query heads blockIdx.z * GB .. + GB - 1 of the kv head's G, into
// o_part / m_part / l_part. The body of every split kernel.
template <typename T, typename KT, int D, int NG, bool PAGED>
__device__ __forceinline__ void split_rows(
    const T* __restrict__ q, const Rows<KT, PAGED>& cache,
    const uint8_t* __restrict__ mask, float* __restrict__ o_part,
    float* __restrict__ m_part, float* __restrict__ l_part, int G, int GB,
    float sm_scale) {
  constexpr bool SCALED = std::is_same<KT, int8_t>::value;
  constexpr int C = lane_cols<KT, NG, D>();
  constexpr int LA = D / C;    // live lanes per row
  constexpr int L = row_lanes<D, C>();  // lanes per row
  constexpr int RP = BK / L;   // rows per pass; L passes cover the split
  constexpr int BYTES = C * (int)sizeof(KT);
  constexpr int NW = BYTES / 4;  // words per lane, row and tensor
  // K and V of every pass in flight together while both fit in 64
  // registers a thread; past that V waits for the dot products
  constexpr bool STAGED = 2 * L * NW > 64;
  // passes a group: all of them while one tensor's fit in 128 registers,
  // else groups of 64 registers
  constexpr int PG = L * NW <= 128 ? L : 64 / NW;
  constexpr int NPG = L / PG;
  static_assert(D % C == 0 && L <= 32 && BYTES % 4 == 0, "lanes per row");
  static_assert(L % PG == 0 && (NPG == 1 || STAGED), "pass groups");
  __shared__ long long srow[BK];  // (row, kv head) index; -1 if masked
  __shared__ float sp[NG][BK];    // lane-summed dot products, then p
  __shared__ float red[NG][WARPS];
  __shared__ float so[WARPS][NG][D];

  const int W = cache.W, Hkv = cache.Hkv;
  const int bh = blockIdx.x;  // b * Hkv + hk
  const int b = bh / Hkv, hk = bh % Hkv;
  const int split = blockIdx.y, ns = gridDim.y;
  const int g0 = blockIdx.z * GB;         // this block's first query head
  const int Gz = min(GB, G - g0);         // and its count
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid % L, rs = tid / L;  // column slice, row slot
  const bool live = LA == L || c < LA;  // an idle lane owns no columns

  // row metadata: thread tid reads logical row split * BK + tid's mask bit
  // and table entry together, then (int8) its scales
  long long r = -1;
  float ksc = 0.f, vsc = 0.f;
  {
    const int j = split * BK + tid;
    if (j < W) {
      const bool on = mask[(long long)b * W + j] != 0;
      const long long at = cache.at(b, j, hk);
      if (on) {
        r = at;
        if constexpr (SCALED) {
          ksc = to_float(cache.ks[r]);
          vsc = to_float(cache.vs[r]);
        }
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
      qr[g][u] = ((NG == 1 || g < Gz) && live)
                     ? to_float(q[((long long)bh * G + g0 + g) * D + c * C +
                                  u])
                     : 0.f;
  }
  __syncthreads();

  uint32_t kw[PG][NW], vw[PG][NW];
  // dot products, group by group: lane partials, summed across the
  // row's lanes
#pragma unroll
  for (int pg = 0; pg < NPG; ++pg) {
    load_passes<D, C, L>(cache.k, srow, rs, c, live, pg * PG, kw);
    if constexpr (!STAGED)
      load_passes<D, C, L>(cache.v, srow, rs, c, live, 0, vw);
#pragma unroll
    for (int pp = 0; pp < PG; ++pp) {
      const int jj = (pg * PG + pp) * RP + rs;
      float s[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) s[g] = 0.f;
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const float kf = unpack<KT>(kw[pp], u);
#pragma unroll
        for (int g = 0; g < NG; ++g) s[g] += qr[g][u] * kf;
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < NG; ++g)
          s[g] += __shfl_xor_sync(FULL, s[g], off);
      }
      if (c == 0) {
#pragma unroll
        for (int g = 0; g < NG; ++g)
          if (NG == 1 || g < Gz) sp[g][jj] = s[g];
      }
    }
  }
  if constexpr (STAGED)
    load_passes<D, C, L>(cache.v, srow, rs, c, live, 0, vw);
  __syncthreads();

  // split-local softmax statistics, per query head; thread tid owns row
  // tid and scales its score: the K scale (int8), then 1/sqrt(D)
  float sc[NG], m[NG], l[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    sc[g] = RT_NEG_INF;
    if (NG == 1 || g < Gz) {
      if (r >= 0) {
        if constexpr (SCALED)
          sc[g] = sp[g][tid] * ksc * sm_scale;
        else
          sc[g] = sp[g][tid] * sm_scale;
      }
      const float w = warp_max(sc[g]);
      if (lane == 0) red[g][warp] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    m[g] = RT_NEG_INF;
    if (NG == 1 || g < Gz) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) m[g] = fmaxf(m[g], red[g][w]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    if (NG == 1 || g < Gz) {
      const float p = expf(sc[g] - m[g]);
      if constexpr (SCALED)
        sp[g][tid] = p * vsc;
      else
        sp[g][tid] = p;
      const float w = warp_sum(p);
      if (lane == 0) red[g][warp] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    l[g] = 0.f;
    if (NG == 1 || g < Gz) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) l[g] += red[g][w];
    }
  }

  // o = sum over rows of p * v: a masked row has v = 0 (never read), so
  // it adds +0 and leaves every sum as it is
  float acc[NG][C];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int u = 0; u < C; ++u) acc[g][u] = 0.f;
  }
#pragma unroll
  for (int pg = 0; pg < NPG; ++pg) {
    if (pg > 0) load_passes<D, C, L>(cache.v, srow, rs, c, live, pg * PG, vw);
#pragma unroll
    for (int pp = 0; pp < PG; ++pp) {
      const int jj = (pg * PG + pp) * RP + rs;
      float pv[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g)
        pv[g] = (NG == 1 || g < Gz) ? sp[g][jj] : 0.f;
#pragma unroll
      for (int u = 0; u < C; ++u) {
        const float vf = unpack<KT>(vw[pp], u);
#pragma unroll
        for (int g = 0; g < NG; ++g) acc[g][u] += pv[g] * vf;
      }
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
  if (lane < L && live) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (NG == 1 || g < Gz) {
#pragma unroll
        for (int u = 0; u < C; ++u) so[warp][g][c * C + u] = acc[g][u];
      }
    }
  }
  __syncthreads();

  const long long base = ((long long)bh * ns + split) * G + g0;
  for (int e = tid; e < Gz * D; e += BK) {
    const int g = e / D, d = e % D;
    float t = so[0][g][d];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) t += so[w][g][d];
    o_part[base * D + e] = t;
  }
  if (tid == 0) {
    for (int g = 0; g < Gz; ++g) {
      m_part[base + g] = m[g];
      l_part[base + g] = l[g];
    }
  }
}

// The split kernel of the bf16/f32 pair (T = KT).
template <typename T, int D, int NG, bool PAGED>
__global__ void __launch_bounds__(BK)
split_rows_kernel(const T* __restrict__ q, const Rows<T, PAGED> cache,
                  const uint8_t* __restrict__ mask,
                  float* __restrict__ o_part, float* __restrict__ m_part,
                  float* __restrict__ l_part, int G, int GB,
                  float sm_scale) {
  split_rows<T, T, D, NG, PAGED>(q, cache, mask, o_part, m_part, l_part, G,
                                 GB, sm_scale);
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

// The two launches of a call for q/out of type T over a cache stored as KT,
// handed to op with the split kernel: pick(d, g) gives the split kernel
// for head dim d and bucket g of the query heads a block computes, both
// std::integral_constant: G itself up to 8, past that ceil(G / 8) blocks
// of GB = ceil(G / ceil(G / 8)) heads (G 12: 2 x 6, G 16: 2 x 8). The
// split kernel runs one block of BK threads per (b * Hkv + hk, split of BK
// rows, part of the group); the merge one block of D threads per
// (b * Hkv + hk, query head of the group). `family` names the split
// kernel in its plan.
template <typename T, typename KT, bool PAGED, typename Pick, class Op>
int dispatch(Pick pick, const char* family, int B, int W, int Hkv, int G,
             int D, const Op& op) {
  if (B <= 0 || W <= 0) return 0;
  if (G < 1 || G > MAX_GROUP)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ngrp = (G + MAXG - 1) / MAXG;  // blocks a (split, kv head)
  const int GB = (G + ngrp - 1) / ngrp;    // query heads a block
  const int NG = GB == 1 ? 1 : GB == 2 ? 2 : GB <= 4 ? 4 : 8;
  using Kernel = decltype(pick(std::integral_constant<int, 16>{},
                               std::integral_constant<int, 1>{}));
  auto bucket = [&](auto d) -> Kernel {
    if (NG == 1) return pick(d, std::integral_constant<int, 1>{});
    if (NG == 2) return pick(d, std::integral_constant<int, 2>{});
    if (NG == 4) return pick(d, std::integral_constant<int, 4>{});
    return pick(d, std::integral_constant<int, 8>{});
  };
  Kernel kernel;
  switch (D) {
    case 16: kernel = bucket(std::integral_constant<int, 16>{}); break;
    case 32: kernel = bucket(std::integral_constant<int, 32>{}); break;
    case 64: kernel = bucket(std::integral_constant<int, 64>{}); break;
    case 80: kernel = bucket(std::integral_constant<int, 80>{}); break;
    case 128: kernel = bucket(std::integral_constant<int, 128>{}); break;
    case 160: kernel = bucket(std::integral_constant<int, 160>{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ns = (W + BK - 1) / BK;
  const RtLaunch split = rt_plan(
      (const void*)kernel, dim3((unsigned)(B * Hkv), (unsigned)ns,
                                (unsigned)ngrp),
      dim3(BK), 0, "%s<%s,%d,%d,%s>", family, rt_tname<T>(), D, NG,
      PAGED ? "paged" : "contiguous");
  const RtLaunch merge = rt_plan(
      (const void*)merge_kernel<T>, dim3((unsigned)(B * Hkv), (unsigned)G),
      dim3((unsigned)D), 0, "merge_kernel<%s>", rt_tname<T>());
  return op(split, kernel, merge, GB);
}

// Launches split + merge over the cache rows; ks and vs are the int8
// cache's scales, else unused. For a contiguous cache W is its length and
// ps, NP are unused; for a paged one W = NP * ps logical rows.
template <typename T, typename KT, bool PAGED>
struct Run {
  const void *q, *k, *v, *ks, *vs, *pt, *mask;
  void *o_part, *m_part, *l_part, *out;
  int W, Hkv, G, D, ps, NP;
  cudaStream_t s;

  template <typename Kernel>
  int operator()(const RtLaunch& split, Kernel kernel, const RtLaunch& merge,
                 int GB) const {
    const Rows<KT, PAGED> rows{
        static_cast<const KT*>(k), static_cast<const KT*>(v),
        static_cast<const __nv_bfloat16*>(ks),
        static_cast<const __nv_bfloat16*>(vs), static_cast<const int*>(pt),
        W, Hkv, ps, NP};
    float* op = static_cast<float*>(o_part);
    float* mp = static_cast<float*>(m_part);
    float* lp = static_cast<float*>(l_part);
    kernel<<<rt_grid(split), rt_block(split), split.smem, s>>>(
        static_cast<const T*>(q), rows, static_cast<const uint8_t*>(mask),
        op, mp, lp, G, GB, 1.0f / sqrtf((float)D));
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    merge_kernel<T><<<rt_grid(merge), rt_block(merge), merge.smem, s>>>(
        op, mp, lp, static_cast<T*>(out), (int)split.grid[1], G, D);
    return static_cast<int>(cudaGetLastError());
  }
};

struct RecordPlan {
  RtPlanSink* sink;
  template <typename Kernel>
  int operator()(const RtLaunch& split, Kernel, const RtLaunch& merge,
                 int) const {
    sink->add(split);
    sink->add(merge);
    return 0;
  }
};

// Split + merge for q/out of type T over a cache stored as KT.
template <typename T, typename KT, bool PAGED, typename Pick>
int launch(Pick pick, const char* family, const void* q, const void* k,
           const void* v, const void* ks, const void* vs, const void* pt,
           const void* mask, void* o_part, void* m_part, void* l_part,
           void* out, int B, int W, int Hkv, int G, int D, int ps, int NP,
           void* stream) {
  const Run<T, KT, PAGED> run{q, k, v, ks, vs, pt, mask, o_part, m_part,
                              l_part, out, W, Hkv, G, D, ps, NP,
                              static_cast<cudaStream_t>(stream)};
  return dispatch<T, KT, PAGED>(pick, family, B, W, Hkv, G, D, run);
}

// The launches of a call, for a plan export: the count, at most cap
// written to out; a negative CUDA error code where the call would refuse.
template <typename T, typename KT, bool PAGED, typename Pick>
int plan(Pick pick, const char* family, int B, int W, int Hkv, int G, int D,
         RtLaunch* out, int cap) {
  RtPlanSink sink{out, cap, 0};
  const int e = dispatch<T, KT, PAGED>(pick, family, B, W, Hkv, G, D,
                                       RecordPlan{&sink});
  return e ? -e : sink.n;
}

// The bf16/f32 pair's kernels (T = KT).
template <typename T, bool PAGED>
struct SamePick {
  template <typename Dc, typename Gc>
  auto operator()(Dc, Gc) const {
    return &split_rows_kernel<T, Dc::value, Gc::value, PAGED>;
  }
};

template <typename T, bool PAGED>
int launch_same(const void* q, const void* k, const void* v, const void* pt,
                const void* mask, void* o_part, void* m_part, void* l_part,
                void* out, int B, int W, int Hkv, int G, int D, int ps,
                int NP, void* stream) {
  return launch<T, T, PAGED>(SamePick<T, PAGED>{}, "split_rows_kernel", q, k,
                             v, nullptr, nullptr, pt, mask, o_part, m_part,
                             l_part, out, B, W, Hkv, G, D, ps, NP, stream);
}

template <typename T, bool PAGED>
int plan_same(int B, int W, int Hkv, int G, int D, RtLaunch* out, int cap) {
  return plan<T, T, PAGED>(SamePick<T, PAGED>{}, "split_rows_kernel", B, W,
                           Hkv, G, D, out, cap);
}

}  // namespace splitkv
}  // namespace
