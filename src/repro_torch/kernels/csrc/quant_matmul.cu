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
// operations (2.6 TFLOP at minicpm-2b's widths) on ~2.7 GB of x and out.
//
// The Pallas kernel keeps the whole K of an x row block and a weight
// column block in VMEM; a Hopper block's 227 KB cannot hold them (K is
// 2048-6144 here), so each block owns one output tile and walks K in
// stages through shared memory. Sums are f32; the per-column scale
// multiplies the f32 sum once, in the epilogue, and the result is
// rounded once to x's dtype, as the plain version computes. The ragged
// T, N and K edges are masked: nothing is padded or copied. Two bodies,
// chosen by the row count:
//
// * T > 16: quant_matmul_mma, on the tensor cores with warp-level
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (not wgmma).
//   int8 -> bf16 is exact for -127..127, so the weight enters the
//   products as it is. 8 warps (2 along T, 4 along N, 32 columns each)
//   own a 128 x 128 output tile for bf16 x (64 x 32 a warp) and
//   64 x 128 for f32 x. K is walked in 64-deep stages through a ring of
//   three 16-byte cp.async stages, x as rows of its own dtype and w as
//   int8 rows (16 weights a copy), one barrier a stage; the copy
//   zero-fills past T, K and N. Where K, N or a pointer's alignment
//   forbids whole 16-byte runs, that operand is loaded element by
//   element into the same stage instead. The B fragments are built in
//   registers straight from the int8 bytes: ldmatrix.trans reads the
//   int8 rows as 8 x 8 matrices of byte pairs, so a lane gets rows k 2t
//   and 2t + 1 of columns 2g and 2g + 1, which are the fragments of two
//   n-tiles, the even columns and the odd ones; each byte becomes a bf16
//   exactly (the float with bits 0x4B000000 | (b ^ 0x80), less
//   2^23 + 128, keeps its top 16 bits). Rows are padded by 16 bytes, so
//   ldmatrix reads without bank conflicts. bf16 x is read with ldmatrix.
//   f32 x is split as it is read into three bf16 pieces, hi = bf16(x),
//   mid = bf16(x - hi), lo = bf16(x - hi - mid), whose sum is x exactly;
//   each piece times an int8 weight is exact, so the three products
//   differ from the f32 sum only in their order. hi goes into one
//   accumulator and mid + lo into a second, so the rounding of the small
//   pieces' sums stays ~2^-8 of the large one's. Scaled and rounded, the
//   tile leaves through shared memory in 16-byte stores. Measured on an
//   H100 SXM at 700 W (python -m repro_torch.bench.quant_matmul, bf16
//   x, T 1024, K 2304, N 17280), these choices beat the alternatives:
//   64-deep stages, 3 deep, took 0.40 ms against 0.44 for 32-deep ones,
//   4 deep; the fragments built in registers 0.36 ms against 0.40 for a
//   stage widened once to a bf16 tile in shared memory and read with
//   ldmatrix.trans; with 32-deep stages and the widened tile, 64-row tiles
//   for bf16 x took 0.50-0.55 ms against 0.44 for 128-row ones.
// * T <= 16 (decode): quant_matmul_kernel, 16 x 64 tiles on the f32
//   CUDA cores, 64-deep stages with the next stage's loads held in
//   registers, each thread loading 16 int8 weights of one row with one
//   16-byte load along N (masked byte loads where N % 16 or the pointer
//   forbids) and widening them to f32 on the way into shared memory. It
//   gives twice the blocks of a 64 x 128 tile to stream the weight: at
//   T 1 and 4 it ran 2.4-2.8x (K 2304, N 17280) and 1.6-1.8x (K 6144,
//   N 8192) faster than a 64 x 128 f32 tile on an H100 SXM at 700 W
//   (python -m repro_torch.bench.quant_matmul, each tile built alone).
#include "common.cuh"
#include "mma.cuh"
#include "plan.cuh"

namespace {

constexpr int NT = 256;       // threads per block, 16 x 16
constexpr int NTX = 16;       // threads along N
constexpr int NTY = NT / NTX; // threads along T
constexpr int WVEC = 16;      // int8 weights per 16-byte load

// The b-th int8 of a little-endian word, sign-extended, as float.
__device__ __forceinline__ float byte_to_float(unsigned int word, int b) {
  return static_cast<float>(static_cast<int>(word << (24 - 8 * b)) >> 24);
}

// The decode tile: TM x TN outputs per thread, BK-deep stages.
constexpr int TM = 1, TN = 4, BK = 64;

// BK * BN / WVEC == NT, so every thread loads one 16-byte run of weights
// per stage.
template <typename T>
__global__ void __launch_bounds__(NT)
quant_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, T* __restrict__ out,
                    int n_rows, int K, int N, bool vec) {
  constexpr int BM = NTY * TM, BN = NTX * TN;  // 16 x 64
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

// ---------------------------------------------------------------------------
// T > 16: the tensor-core body
// ---------------------------------------------------------------------------
constexpr int MMA_THREADS = 256;  // 8 warps: 2 along T, 4 along N
constexpr int MMA_BN = 128;       // output columns a block, 32 a warp
constexpr int MMA_BK = 64;        // K per stage
constexpr int MMA_STAGES = 3;     // depth of the cp.async ring
constexpr int WLD = MMA_BN + 16;  // int8 stage row, bytes
constexpr int OLD = MMA_BN + 8;   // output staging row, elements

// bf16 x: one piece, 4 m-tiles of 16 rows a warp; f32 x: three pieces
// and a second accumulator, 2 m-tiles a warp.
template <typename T>
struct XTile {
  static constexpr bool SPLIT = sizeof(T) == 4;
  static constexpr int MT = SPLIT ? 2 : 4;
  static constexpr int BM = 2 * 16 * MT;            // output rows a block
  static constexpr int XLD = MMA_BK + 8;            // padded x row, elements
  static constexpr int EPC = 16 / (int)sizeof(T);   // elements a 16-byte run
  static constexpr int XCH = MMA_BK / EPC;          // runs an x row a stage
  static constexpr size_t X_BYTES = sizeof(T) * BM * XLD;
  static constexpr size_t SMEM = MMA_STAGES * (X_BYTES + MMA_BK * WLD);
  static_assert(sizeof(T) * BM * OLD <= MMA_STAGES * X_BYTES,
                "the output tile is staged in the x ring");
};

// Four int8 (one little-endian word) -> two packed bf16 pairs, exactly:
// bytes 0 and 2 into p02, bytes 1 and 3 into p13.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t word, uint32_t& p02,
                                               uint32_t& p13) {
  const uint32_t u = word ^ 0x80808080u;  // b + 128 as unsigned bytes
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)  // 2^23 + (b + 128), less 2^23 + 128
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
           8388736.f;
  p02 = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[2]), 0x7632);
  p13 = __byte_perm(__float_as_uint(f[1]), __float_as_uint(f[3]), 0x7632);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename T>
__global__ void __launch_bounds__(MMA_THREADS, 2)
quant_matmul_mma(const T* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, T* __restrict__ out,
                 int n_rows, int K, int N, bool xvec, bool wvec, bool ovec) {
  using X = XTile<T>;
  constexpr int MT = X::MT, BM = X::BM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // [STAGES][BM][XLD]
  int8_t* ws = reinterpret_cast<int8_t*>(smem_raw + MMA_STAGES * X::X_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp >> 2) * MT * 16, wn0 = (warp & 3) * 32;
  const long long m0 = (long long)blockIdx.y * BM;
  const int n0 = blockIdx.x * MMA_BN;
  const int n_k = (K + MMA_BK - 1) / MMA_BK;

  auto load_stage = [&](int kt, int st) {
    const int k0 = kt * MMA_BK;
    T* xd = xs + st * BM * X::XLD;
    for (int c = tid; c < BM * X::XCH; c += MMA_THREADS) {
      const int r = c / X::XCH, kc = (c % X::XCH) * X::EPC;
      const long long row = m0 + r;
      const int kg = k0 + kc;
      T* dst = xd + r * X::XLD + kc;
      if (xvec) {
        const bool ok = row < n_rows && kg < K;
        cp_async16(smem_addr(dst), ok ? x + row * K + kg : x, ok);
      } else {
        for (int e = 0; e < X::EPC; ++e)
          dst[e] = (row < n_rows && kg + e < K) ? x[row * K + kg + e]
                                                : from_float<T>(0.f);
      }
    }
    int8_t* wd = ws + st * MMA_BK * WLD;
    for (int c = tid; c < MMA_BK * (MMA_BN / 16); c += MMA_THREADS) {
      const int r = c / (MMA_BN / 16), nc = (c % (MMA_BN / 16)) * 16;
      const int kg = k0 + r, ng = n0 + nc;
      int8_t* dst = wd + r * WLD + nc;
      if (wvec) {
        const bool ok = kg < K && ng < N;
        cp_async16(smem_addr(dst), ok ? w + (long long)kg * N + ng : w, ok);
      } else {
        for (int e = 0; e < 16; ++e)
          dst[e] = (kg < K && ng + e < N) ? w[(long long)kg * N + ng + e]
                                          : int8_t(0);
      }
    }
  };

  float acc[MT][4][4];
  float acc2[X::SPLIT ? MT : 1][4][4];  // mid + lo of f32 x
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mt][nt][e] = 0.f;
        if constexpr (X::SPLIT) acc2[mt][nt][e] = 0.f;
      }

#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    const int st = kt % MMA_STAGES;
    cp_async_wait<MMA_STAGES - 2>();  // stage kt has landed
    __syncthreads();                  // and every warp is done with kt - 1
    {
      const int nk = kt + MMA_STAGES - 1;
      if (nk < n_k) load_stage(nk, nk % MMA_STAGES);
      cp_async_commit();
    }
    const T* xt = xs + st * BM * X::XLD;
    const int8_t* wt = ws + st * MMA_BK * WLD;
#pragma unroll
    for (int kk = 0; kk < MMA_BK; kk += 16) {
      // the int8 rows read as 8 x 8 b16 matrices, transposed: a lane gets
      // rows k 2t, 2t+1 of columns 2g, 2g+1; n-tile 2h holds the even
      // columns wn0 + 16h + 2g, n-tile 2h + 1 the odd ones
      uint32_t bw[4][2];
      {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_addr(wt + (kk + (lane & 7) +
                                             ((lane >> 3) & 1) * 8) * WLD +
                                       wn0 + (lane >> 4) * 16));
        int8x4_to_bf16(r[0], bw[0][0], bw[1][0]);
        int8x4_to_bf16(r[1], bw[0][1], bw[1][1]);
        int8x4_to_bf16(r[2], bw[2][0], bw[3][0]);
        int8x4_to_bf16(r[3], bw[2][1], bw[3][1]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = wm0 + mt * 16;
        if constexpr (!X::SPLIT) {
          uint32_t a[4];
          ldmatrix_x4(a, smem_addr(xt + (row + (lane & 15)) * X::XLD + kk +
                                   (lane >> 4) * 8));
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[mt][nt], a, bw[nt][0], bw[nt][1]);
        } else {
          const float* p = reinterpret_cast<const float*>(xt) +
                           (row + g) * X::XLD + kk + 2 * t;
          float2 v[4] = {*reinterpret_cast<const float2*>(p),
                         *reinterpret_cast<const float2*>(p + 8 * X::XLD),
                         *reinterpret_cast<const float2*>(p + 8),
                         *reinterpret_cast<const float2*>(p + 8 * X::XLD + 8)};
          uint32_t hi[4], mid[4], lo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            hi[i] = split_bf16(v[i].x, v[i].y);
            mid[i] = split_bf16(v[i].x, v[i].y);
            lo[i] = pack_bf16(v[i].x, v[i].y);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_bf16(acc[mt][nt], hi, bw[nt][0], bw[nt][1]);
            mma_bf16(acc2[mt][nt], mid, bw[nt][0], bw[nt][1]);
            mma_bf16(acc2[mt][nt], lo, bw[nt][0], bw[nt][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: scaled once, rounded once, staged in the x ring
  T* so = xs;  // [BM][OLD]
  // n-tiles 2h and 2h + 1 hold columns wn0 + 16h + 4t .. + 3 of a lane
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = wn0 + 16 * h + 4 * t;
      float sc[4], c[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sc[j] = n0 + col + j < N ? scale[n0 + col + j] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half)      // rows g, g + 8
#pragma unroll
        for (int j = 0; j < 4; ++j) {           // columns col + j
          const int nt = 2 * h + (j & 1), e = 2 * half + (j >> 1);
          float v = acc[mt][nt][e];
          if constexpr (X::SPLIT) v += acc2[mt][nt][e];
          c[half][j] = v * sc[j];
        }
      const int r = wm0 + mt * 16 + g;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        T* dst = so + (r + 8 * half) * OLD + col;
        store_pair(dst, c[half][0], c[half][1]);
        store_pair(dst + 2, c[half][2], c[half][3]);
      }
    }
  __syncthreads();
  constexpr int OCH = MMA_BN / X::EPC;  // 16-byte runs an output row
  for (int c = tid; c < BM * OCH; c += MMA_THREADS) {
    const int r = c / OCH, nc = (c % OCH) * X::EPC;
    const long long row = m0 + r;
    const int n = n0 + nc;
    if (row >= n_rows || n >= N) continue;
    T* dst = out + row * N + n;
    const T* src = so + r * OLD + nc;
    if (ovec && n + X::EPC <= N)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    else
      for (int e = 0; e < X::EPC && n + e < N; ++e) dst[e] = src[e];
  }
}

// ---------------------------------------------------------------------------
// Launch plans and the body choice
// ---------------------------------------------------------------------------
// Decode tile: one block of NT per (BN columns, BM rows).
template <typename T>
RtLaunch plan_simt(int n_rows, int N) {
  constexpr int BM = NTY * TM, BN = NTX * TN;
  return rt_plan((const void*)quant_matmul_kernel<T>,
                 dim3((unsigned)((N + BN - 1) / BN),
                      (unsigned)((n_rows + BM - 1) / BM)),
                 dim3(NT), 0, "quant_matmul_kernel<%s>", rt_tname<T>());
}

// Tensor-core tile: one block of MMA_THREADS per (MMA_BN columns, X::BM
// rows), the cp.async ring in dynamic shared memory.
template <typename T>
RtLaunch plan_mma(int n_rows, int N) {
  using X = XTile<T>;
  return rt_plan((const void*)quant_matmul_mma<T>,
                 dim3((unsigned)((N + MMA_BN - 1) / MMA_BN),
                      (unsigned)((n_rows + X::BM - 1) / X::BM)),
                 dim3(MMA_THREADS), X::SMEM, "quant_matmul_mma<%s>",
                 rt_tname<T>());
}

// Decode (n_rows <= 16): 16 x 64 tiles on the CUDA cores; else the
// tensor cores. Handed to op with its plan.
template <typename T, class Op>
int dispatch(int n_rows, int N, const Op& op) {
  if (n_rows <= NTY)
    return op(plan_simt<T>(n_rows, N), &quant_matmul_kernel<T>);
  return op(plan_mma<T>(n_rows, N), &quant_matmul_mma<T>);
}

template <typename T>
using SimtKernel = void (*)(const T*, const int8_t*, const float*, T*, int,
                            int, int, bool);
template <typename T>
using MmaKernel = void (*)(const T*, const int8_t*, const float*, T*, int,
                           int, int, bool, bool, bool);

template <typename T>
struct Run {
  const void *x, *w, *scale;
  void* out;
  int n_rows, K, N;
  cudaStream_t s;

  int operator()(const RtLaunch& p, SimtKernel<T> kern) const {
    const bool vec = N % WVEC == 0 && rt_aligned16(w);
    kern<<<rt_grid(p), rt_block(p), p.smem, s>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<T*>(out), n_rows, K, N,
        vec);
    return static_cast<int>(cudaGetLastError());
  }
  int operator()(const RtLaunch& p, MmaKernel<T> kern) const {
    const int e = rt_smem_optin(p);
    if (e) return e;
    const bool xvec = (K * sizeof(T)) % 16 == 0 && rt_aligned16(x);
    const bool wvec = N % 16 == 0 && rt_aligned16(w);
    const bool ovec = (N * sizeof(T)) % 16 == 0 && rt_aligned16(out);
    kern<<<rt_grid(p), rt_block(p), p.smem, s>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<T*>(out), n_rows, K, N,
        xvec, wvec, ovec);
    return static_cast<int>(cudaGetLastError());
  }
};

struct RecordPlan {
  RtPlanSink* sink;
  template <typename K>
  int operator()(const RtLaunch& p, K) const {
    sink->add(p);
    return 0;
  }
};

}  // namespace

extern "C" int rt_quant_matmul(const void* x, const void* w, const void* scale,
                               void* out, int n_rows, int K, int N, int dtype,
                               void* stream) {
  if (n_rows <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_BF16)
    return dispatch<__nv_bfloat16>(
        n_rows, N, Run<__nv_bfloat16>{x, w, scale, out, n_rows, K, N, s});
  if (dtype == RT_F32)
    return dispatch<float>(n_rows, N,
                           Run<float>{x, w, scale, out, n_rows, K, N, s});
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch rt_quant_matmul makes: the count, at most cap written to
// out; a negative CUDA error code where it would refuse.
extern "C" int rt_quant_matmul_plan(int n_rows, int K, int N, int dtype,
                                    RtLaunch* out, int cap) {
  (void)K;
  if (n_rows <= 0 || N <= 0) return 0;
  RtPlanSink sink{out, cap, 0};
  const RecordPlan op{&sink};
  int e;
  if (dtype == RT_BF16)
    e = dispatch<__nv_bfloat16>(n_rows, N, op);
  else if (dtype == RT_F32)
    e = dispatch<float>(n_rows, N, op);
  else
    e = static_cast<int>(cudaErrorInvalidValue);
  return e ? -e : sink.n;
}
