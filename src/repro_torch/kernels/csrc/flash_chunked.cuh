// Flash prefill at head dim 80 (zamba2-2.7b, hubert-xlarge) in the plain
// version's order, included by flash_attention.cu for D 80 in both dtypes.
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
// by `lanes`), then (((a0 + a1) + a2) + a3) (aten_lane_sum) and a
// shuffle-down tree with offsets lanes / 2 .. 1 (aten_tree). A masked key
// has p = 0: adding its p, or its p * v to a chain, changes no bit, so
// key tiles and chunks masked for every row of a block are skipped, and
// the rest of a tile runs with p = 0 where a row does not attend. On the
// card (torch 2.11) the output equals the plain version's bit for bit at
// every R >= 16 tried, G 1-8, windows, chunks of 64-512 and ragged ones,
// n % 4 != 0 (tests/test_torch_cuda.py); below 16 rows PyTorch gives a
// row more than 32 threads, which this body does not copy, and it holds
// the one-ulp bar. Where the last chunk holds one key (T % chunk == 1)
// the plain version's products with it round apart in f32 in the rows
// that attend it, as they did with the body before this one.
//
// Bound on this card: operations on the f32 CUDA cores. Bit equality
// rules out the tensor cores (their products sum in another order), so
// the floor is 4 * D operations a (query, key) pair at 67 TFLOP/s. The
// body is the SGEMM recipe, which keeps every chain's order: a thread
// owns a register micro-tile and runs its chains side by side, each
// still over d (scores) or keys (P.V) in index order.
// * One block of 256 threads per (b * Hq + h, QR = 64 query rows), query
//   tiles longest first (reverse order along S), so causal work balances
//   over the SMs. At chunk 512, 215.75 KiB of shared memory (bf16; f32
//   195.75): one block an SM.
// * Q, K and V live in shared memory as f32 rows padded to D + 4 floats:
//   rows 5 16-byte bank groups apart, so float4 loads meet no conflict.
//   K and V come in 64-key tiles (a chunk's K tiles, then its V tiles)
//   by 16-byte cp.async, the next tile landing while this one is
//   multiplied: f32 straight into the other of two f32 tiles; bf16 into
//   the other of two raw tiles, which each thread widens to f32 (exact)
//   piece by piece, the pieces it copied itself, so one barrier a tile
//   makes it whole. Widening bf16 at each use instead would add an
//   instruction every 4 fmas.
// * Scores: thread (rg, kg) owns rows rg + 16 i and keys kg + 16 j of a
//   64 x 64 tile (4 x 4 chains); at each 4 values of d it loads 4 q and
//   4 k float4 and runs 64 fmas, 8 loads to 64 fmas (the body before:
//   2 loads an fma). The chunk's scores stay in shared memory, since its
//   max precedes every p.
// * Statistics, 4 threads a row and every row at once, in float4 groups
//   of keys (thread p takes groups p + 4 k): max; p written over the
//   row's tiles (0 where it does not attend); ATen's sum, whose 32
//   threads the row's 4 play, 8 each (ATen's thread p + 4 m adds groups
//   p + 4 m + 32 k, here in the exp pass as p comes out), then ATen's
//   tree; alpha. A warp a row, 8 rows in turn, left the cores idle on
//   the chains of each row.
// * P.V: thread (rg, cg) owns rows rg + 16 i and columns 4 cg .. 4 cg +
//   3 and 64 + cg (4 x 5 chains); at each 4 keys it loads 4 p float4
//   and, a key, a v float4 and one v value: 12 loads to 80 fmas.
#pragma once

#include "common.cuh"
#include "mma.cuh"
#include "plan.cuh"

namespace {
namespace chunked {

constexpr int QR = 64;                 // query rows a block
constexpr int KT = 64;                 // keys a K or V tile
constexpr int THREADS = 4 * QR;        // 8 warps: 4 rows a thread
constexpr int WARPS = THREADS / 32;
constexpr int RG = QR / 4;             // row groups (rows rg + RG i)
constexpr int KG = THREADS / RG;       // key groups of a score tile, and
                                       // column groups of P.V
constexpr unsigned FULL = 0xffffffffu;
static_assert(KG == 16 && KT == 4 * KG, "a warp is 4 row x 8 key groups");
static_assert(THREADS == 4 * QR, "the statistics take 4 threads a row");

// f32 row pitch of the Q, K and V tiles: 5 16-byte groups past a
// multiple of 8, so 8 consecutive rows meet in no bank.
template <int D>
__host__ __device__ constexpr int pitch() { return D + 4; }

// Floats of a chunk's score row: whole key tiles, plus 16, so that the
// 16-byte groups of neighbouring rows at one key sit 4 bank groups apart.
__host__ __device__ inline int score_pitch(int chunk) {
  return (chunk + KT - 1) / KT * KT + 16;
}

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

// One of ATen's `lanes` threads' share of the sum of a row's n values
// get(j): its four accumulators (vectors of 4 when n >= 128, the row
// starting `shift` floats past a 16-byte boundary; else 4 values strided
// by `lanes`), then (((a0 + a1) + a2) + a3).
template <typename Get>
__device__ __forceinline__ float aten_lane_sum(Get get, int n, int shift,
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
  return __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
}

// ATen's shuffle-down tree (offsets lanes / 2 .. 1) over the shares s[m]
// of its threads p + 4 m (at most 32), held by the row's 4 threads p =
// 0..3, consecutive lanes of a warp: offsets of 4 and more within a
// thread, 2 and 1 across the 4. Thread 0 of the row gets the sum; every
// lane of the warp calls it.
__device__ __forceinline__ float aten_tree(float (&s)[8], int lanes) {
  if (lanes >= 32) {
#pragma unroll
    for (int m = 0; m < 4; ++m) s[m] = __fadd_rn(s[m], s[m + 4]);
  }
  if (lanes >= 16) {
#pragma unroll
    for (int m = 0; m < 2; ++m) s[m] = __fadd_rn(s[m], s[m + 2]);
  }
  if (lanes >= 8) s[0] = __fadd_rn(s[0], s[1]);
  float t = s[0];
  if (lanes >= 4) t = __fadd_rn(t, __shfl_down_sync(FULL, t, 2));
  if (lanes >= 2) t = __fadd_rn(t, __shfl_down_sync(FULL, t, 1));
  return t;
}

// Keys [lo, hi] of chunk [c0, c0 + n) that query position qi attends.
__device__ __forceinline__ void key_range(int qi, int c0, int n, int causal,
                                          int window, int& lo, int& hi) {
  lo = c0;
  hi = c0 + n - 1;
  if (causal && hi > qi) hi = qi;
  if (window && lo < qi - window + 1) lo = qi - window + 1;
}

// 16 bytes of T at p: one vector load where q, k and v are 16-byte
// aligned (every fresh allocation), else element by element.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint4 r;
  if constexpr (sizeof(T) == 2) {
    const unsigned short* e = reinterpret_cast<const unsigned short*>(p);
    r.x = e[0] | (unsigned)e[1] << 16;
    r.y = e[2] | (unsigned)e[3] << 16;
    r.z = e[4] | (unsigned)e[5] << 16;
    r.w = e[6] | (unsigned)e[7] << 16;
  } else {
    const unsigned* e = reinterpret_cast<const unsigned*>(p);
    r = make_uint4(e[0], e[1], e[2], e[3]);
  }
  return r;
}

// 16 bytes of T as f32 at dst (16-byte aligned): 8 bf16 values (each
// widened exactly) or 4 f32 values.
template <typename T>
__device__ __forceinline__ void store_f32(float* dst, uint4 r) {
  if constexpr (sizeof(T) == 2) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int h = 0; h < 2; ++h)
      reinterpret_cast<float4*>(dst)[h] = make_float4(
          __uint_as_float(w[2 * h] << 16),
          __uint_as_float(w[2 * h] & 0xffff0000u),
          __uint_as_float(w[2 * h + 1] << 16),
          __uint_as_float(w[2 * h + 1] & 0xffff0000u));
  } else {
    *reinterpret_cast<float4*>(dst) =
        make_float4(__uint_as_float(r.x), __uint_as_float(r.y),
                    __uint_as_float(r.z), __uint_as_float(r.w));
  }
}

// The 16-byte pieces of a KT-row tile of T that thread t copies, t +
// THREADS u, with their offsets worked out once: in the source (row
// stride `stride` elements) and in shared memory (`pitch` bytes a row).
template <typename T, int D>
struct Pieces {
  static constexpr int CH = D * (int)sizeof(T) / 16;   // pieces a row
  static constexpr int N = (KT * CH + THREADS - 1) / THREADS;
  long long from[N];
  int to[N], row[N];

  __device__ __forceinline__ Pieces(long long stride, int pitch) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int e = threadIdx.x + THREADS * u, c = e % CH;
      row[u] = e < KT * CH ? e / CH : KT;       // KT: no piece
      from[u] = row[u] * stride + c * (16 / (int)sizeof(T));
      to[u] = row[u] * pitch + c * 16;
    }
  }

  // Rows [0, rows) of the tile at src into dst; rows past them zero. With
  // `vec` (q, k and v 16-byte aligned, as every fresh allocation is) by
  // cp.async, which the caller commits; else by loads and stores.
  __device__ __forceinline__ void copy(unsigned char* dst, const T* src,
                                       int rows, bool vec) const {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      if (row[u] == KT) continue;
      if (vec)
        cp_async16(smem_addr(dst + to[u]), row[u] < rows ? src + from[u] : src,
                   row[u] < rows);
      else
        *reinterpret_cast<uint4*>(dst + to[u]) =
            row[u] < rows ? load16(src + from[u], false)
                          : make_uint4(0u, 0u, 0u, 0u);
    }
  }
};

// A bf16 tile as it landed (KT rows of D values, unpadded) widened to an
// f32 tile (rows of pitch<D>() floats), exact; thread t widens the
// pieces Pieces gives it to copy.
template <int D>
__device__ __forceinline__ void widen_tile(float* dst,
                                           const unsigned char* raw) {
  constexpr int CH = D * 2 / 16;
  for (int e = threadIdx.x; e < KT * CH; e += THREADS)
    store_f32<__nv_bfloat16>(dst + (e / CH) * pitch<D>() + (e % CH) * 8,
                             *reinterpret_cast<const uint4*>(raw + e * 16));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_chunked(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int S, int Tn,
                  int Hq, int Hkv, float scale, int causal, int window,
                  int chunk, int lanes_full, int lanes_last) {
  constexpr int P = pitch<D>();
  constexpr int CG = KG;                        // P.V column groups
  constexpr bool RAW = sizeof(T) == 2;          // bf16 lands, then widens
  static_assert(D == 5 * CG, "columns 4 cg .. 4 cg + 3 and 4 CG + cg");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int SP = score_pitch(chunk);
  float* sQ = smem;                             // QR x P
  float* sT = sQ + QR * P;                      // two KT x P K/V tiles
  float* sS = sT + 2 * KT * P;                  // QR x SP: s, then p
  float* sM = sS + QR * SP;                     // QR: m
  float* sL = sM + QR;                          // QR: l
  float* sA = sL + QR;                          // QR: the chunk's alpha
  unsigned char* sR = reinterpret_cast<unsigned char*>(sA + QR);  // RAW:
                                                // two tiles as they land

  const int bh = blockIdx.x;
  const int h = bh % Hq, hk = h / (Hq / Hkv), b = bh / Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * QR;   // longest first
  const int rows = S - q0 < QR ? S - q0 : QR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = (warp >> 1) * 4 + (lane >> 3);     // a warp: 4 row groups
  const int kg = (warp & 1) * 8 + (lane & 7);       // x 8 key/column groups
  const long long qs = (long long)Hq * D, ks = (long long)Hkv * D;
  const T* kb = k + (long long)b * Tn * ks + (long long)hk * D;
  const T* vb = v + (long long)b * Tn * ks + (long long)hk * D;
  const bool vec = ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  {
    constexpr int CH = D * (int)sizeof(T) / 16, EPC = 16 / (int)sizeof(T);
    const T* qb = q + ((long long)b * S + q0) * qs + (long long)h * D;
    for (int e = tid; e < QR * CH; e += THREADS) {
      const int r = e / CH, c = e % CH;
      store_f32<T>(sQ + r * P + c * EPC,
                   r < rows ? load16(qb + r * qs + c * EPC, vec)
                            : make_uint4(0u, 0u, 0u, 0u));
    }
  }
  for (int r = tid; r < QR; r += THREADS) {
    sM[r] = RT_NEG_INF;
    sL[r] = 0.f;
  }

  // The keys some row of the block attends, up to the last row's
  // (causal), from the first row's (window); the chunks that hold them,
  // each a run of K tiles from a tile boundary of the chunk, then as many
  // V tiles.
  const int qlast = q0 + rows - 1;
  const int KLO = window && q0 - window + 1 > 0 ? q0 - window + 1 : 0;
  const int KHI = causal && qlast < Tn - 1 ? qlast : Tn - 1;
  auto first_tile = [&](int c0) {
    return c0 + ((KLO > c0 ? KLO : c0) - c0) / KT * KT;
  };
  auto tiles = [&](int c0) {
    const int hi = c0 + chunk - 1 < KHI ? c0 + chunk - 1 : KHI;
    return (hi - first_tile(c0)) / KT + 1;
  };
  // the tile after (c0, isv, t); false past the last
  auto advance = [&](int& c0, int& isv, int& t) {
    if (t + 1 < tiles(c0)) {
      ++t;
    } else if (!isv) {
      isv = 1;
      t = 0;
    } else {
      c0 += chunk;
      isv = 0;
      t = 0;
    }
    return c0 <= KHI;
  };
  // tile (c0, isv, t) on its way into buffer `buf`: raw bf16, or f32
  // straight into its f32 tile
  const Pieces<T, D> pieces(ks, RAW ? D * 2 : P * 4);
  auto fetch = [&](int c0, int isv, int t, int buf) {
    const int t0 = first_tile(c0) + t * KT;
    pieces.copy(RAW ? sR + buf * KT * D * 2
                    : reinterpret_cast<unsigned char*>(sT + buf * KT * P),
                (isv ? vb : kb) + t0 * ks, Tn - t0, vec);
    cp_async_commit();
  };

  float acc[4][5], pv[4][5];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 5; ++u) acc[i][u] = pv[i][u] = 0.f;

  int c0 = KLO / chunk * chunk, isv = 0, t = 0;
  bool live = KLO <= KHI;
  if (live) fetch(c0, 0, 0, 0);
  for (int buf = 0; live; buf ^= 1) {
    int nc0 = c0, nisv = isv, nt = t;
    const bool more = advance(nc0, nisv, nt);
    // each thread widens the pieces it copied itself, so one barrier
    // makes the tile whole and frees the other buffer
    cp_async_wait<0>();
    if constexpr (RAW) widen_tile<D>(sT + buf * KT * P, sR + buf * KT * D * 2);
    __syncthreads();
    if (more) fetch(nc0, nisv, nt, buf ^ 1);    // lands while this runs
    const float* tile = sT + buf * KT * P;
    const int n = Tn - c0 < chunk ? Tn - c0 : chunk;
    const int tb = first_tile(c0), t0 = tb + t * KT;
    if (!isv) {
      // scores s = (q . k) * scale of a 64 x 64 tile
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        float4 a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(sQ + (rg + RG * i) * P + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          c[j] = *reinterpret_cast<const float4*>(tile + (kg + KG * j) * P +
                                                  d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = __fmaf_rn(a[i].x, c[j].x, s[i][j]);
            s[i][j] = __fmaf_rn(a[i].y, c[j].y, s[i][j]);
            s[i][j] = __fmaf_rn(a[i].z, c[j].z, s[i][j]);
            s[i][j] = __fmaf_rn(a[i].w, c[j].w, s[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sS[(rg + RG * i) * SP + (t0 - c0) + kg + KG * j] =
              __fmul_rn(s[i][j], scale);
    } else {
      if (t == 0) {
        // statistics, 4 threads a row, every row at once, in groups of 4
        // keys (thread p takes groups p + 4 k of the row): m; p = exp(s -
        // m_new) over the keys the row attends, 0 over the rest of the
        // chunk and of its tiles; l; alpha
        const int lanes = n == chunk ? lanes_full : lanes_last;
        const int te = tb + tiles(c0) * KT;
        // the groups of 4 keys P.V or the sum reads
        const int G = ((te - c0 > n ? te - c0 : n) + 3) / 4;
        const int r = tid >> 2, p = tid & 3;
        float* row = sS + r * SP;                   // key c0 + j at row[j]
        float4* row4 = reinterpret_cast<float4*>(row);
        int lo, hi;
        key_range(q0 + r, c0, n, causal, window, lo, hi);
        lo -= c0;
        hi = r < rows ? hi - c0 : lo - 1;
        const bool any = lo <= hi;
        auto part = [](const float4& v, int i) {
          return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
        };
        float mx = RT_NEG_INF;                      // max: any order
        for (int gb = any ? lo / 128 * 32 : G; 4 * gb <= hi; gb += 32) {
          float4 v[8];
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            const int g = gb + p + 4 * m;
            v[m] = row4[g < G ? g : 0];
          }
#pragma unroll
          for (int m = 0; m < 8; ++m)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = 4 * (gb + p + 4 * m) + i;
              if (j >= lo && j <= hi) mx = fmaxf(mx, part(v[m], i));
            }
        }
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float m_old = sM[r];
        const float m_new = fmaxf(m_old, mx);
        // p, and ATen's vectorized sum (n >= 128, rows 16-byte aligned:
        // its thread p + 4 m adds groups p + 4 m + 32 k in k order) as the
        // groups go by
        const int shift = (int)(((long long)bh * S + q0 + r) * n % 4);
        const bool fast = n >= 128 && shift == 0;
        const int fend = fast ? n / 4 : 0;          // the sum's whole groups
        float a[8][4];
#pragma unroll
        for (int m = 0; m < 8; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) a[m][i] = 0.f;
        for (int gb = 0; r < rows && gb < G; gb += 32) {
          if (!any || 4 * gb > hi || 4 * (gb + 32) <= lo) {
#pragma unroll
            for (int m = 0; m < 8; ++m) {           // nothing attended
              const int g = gb + p + 4 * m;
              if (g < G) row4[g] = make_float4(0.f, 0.f, 0.f, 0.f);
            }
            continue;
          }
          float4 v[8];
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            const int g = gb + p + 4 * m;
            v[m] = row4[g < G ? g : 0];
          }
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            const int g = gb + p + 4 * m;
            float o[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int j = 4 * g + i;
              o[i] = j >= lo && j <= hi
                         ? expf(__fsub_rn(part(v[m], i), m_new)) : 0.f;
              if (g < fend) a[m][i] = __fadd_rn(a[m][i], o[i]);
            }
            if (g < G) row4[g] = make_float4(o[0], o[1], o[2], o[3]);
          }
        }
        __syncwarp();
        float s8[8];
        if (fast) {
          // ATen's tail: its threads v < n % 4 add key n - n % 4 + v last
          if (p < n % 4) a[0][0] = __fadd_rn(a[0][0], row[n - n % 4 + p]);
#pragma unroll
          for (int m = 0; m < 8; ++m)
            s8[m] = __fadd_rn(__fadd_rn(__fadd_rn(a[m][0], a[m][1]), a[m][2]),
                              a[m][3]);
        } else {
#pragma unroll
          for (int m = 0; m < 8; ++m)
            s8[m] = aten_lane_sum([&](int j) { return row[j]; }, n, shift,
                                  lanes, p + 4 * m);
        }
        const float psum = __shfl_sync(FULL, aten_tree(s8, lanes), lane & ~3);
        if (p == 0 && r < rows) {
          const float alpha = expf(__fsub_rn(m_old, m_new));
          sL[r] = __fadd_rn(__fmul_rn(sL[r], alpha), psum);
          sM[r] = m_new;
          sA[r] = alpha;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 5; ++u) pv[i][u] = 0.f;
      }
      // p . v of a 64-key tile, keys in index order
      const float* pr = sS + rg * SP + (t0 - c0);
#pragma unroll 8
      for (int j = 0; j < KT; j += 4) {
        float4 p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[i] = *reinterpret_cast<const float4*>(pr + RG * i * SP + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* vr = tile + (j + jj) * P;
          const float4 a = *reinterpret_cast<const float4*>(vr + 4 * kg);
          const float e = vr[4 * CG + kg];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pj = jj == 0 ? p[i].x : jj == 1 ? p[i].y
                           : jj == 2 ? p[i].z : p[i].w;
            pv[i][0] = __fmaf_rn(pj, a.x, pv[i][0]);
            pv[i][1] = __fmaf_rn(pj, a.y, pv[i][1]);
            pv[i][2] = __fmaf_rn(pj, a.z, pv[i][2]);
            pv[i][3] = __fmaf_rn(pj, a.w, pv[i][3]);
            pv[i][4] = __fmaf_rn(pj, e, pv[i][4]);
          }
        }
      }
      if (t == tiles(c0) - 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float alpha = sA[rg + RG * i];
#pragma unroll
          for (int u = 0; u < 5; ++u)
            acc[i][u] = __fadd_rn(__fmul_rn(acc[i][u], alpha), pv[i][u]);
        }
      }
    }
    c0 = nc0;
    isv = nisv;
    t = nt;
    live = more;
  }

  __syncthreads();

  // out = acc / max(l, 1e-30), rounded once
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + RG * i;
    if (r >= rows) continue;
    const float den = fmaxf(sL[r], 1e-30f);
    T* orow = o + (((long long)b * S + q0 + r) * Hq + h) * D;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      orow[4 * kg + u] = from_float<T>(__fdiv_rn(acc[i][u], den));
    orow[4 * CG + kg] = from_float<T>(__fdiv_rn(acc[i][4], den));
  }
}

// Dynamic shared memory of the body at `chunk` (already capped at Tn):
// the Q rows, two K/V tiles, a chunk's scores, m, l and alpha in f32,
// and for bf16 two tiles as they land.
template <typename T, int D>
size_t smem_bytes(int chunk) {
  return sizeof(float) * ((size_t)QR * pitch<D>() + 2 * KT * pitch<D>() +
                          (size_t)QR * score_pitch(chunk) + 3 * QR) +
         (sizeof(T) == 2 ? 2 * (size_t)KT * D * 2 : 0);
}

// The launch of the body for q (B, S, Hq, D), k/v (B, Tn, Hkv, D) with the
// plain version's chunk, already capped at Tn (as it caps it): one block
// of THREADS per (b * Hq + h, QR query rows), the query tiles in reverse
// order.
template <typename T, int D>
RtLaunch plan(int B, int S, int Hq, int chunk) {
  return rt_plan((const void*)flash_fwd_chunked<T, D>,
                 dim3((unsigned)(B * Hq), (unsigned)((S + QR - 1) / QR)),
                 dim3(THREADS), smem_bytes<T, D>(chunk),
                 "flash_fwd_chunked<%s,%d>", rt_tname<T>(), D);
}

}  // namespace chunked
}  // namespace
