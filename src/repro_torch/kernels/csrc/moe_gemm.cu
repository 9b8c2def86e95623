// Grouped (ragged) expert GEMM for Hopper.
//
// Replaces: src/repro/kernels/moe_gemm.py, grouped_gemm_padded (body
// _gemm_kernel): rows sorted by expert into blocks of BM rows, each block
// owned by one expert; block i computes x_pad[i*BM:(i+1)*BM] @ w[e_i],
// f32 accumulation, output rounded once to x's dtype.
//
// Inputs: x_pad (Tp, d), w (E, d, f) (each expert's matrix k rows by n
// columns, row-major), block_expert (nb,) and block_rows (nb,) int32,
// out (Tp, f); all contiguous, Tp = nb * BM, BM = 64 (the wrapper's
// BLOCK_M). block_rows[i] is the number of real rows of block i (a
// prefix of the block). The sort's static bound leaves trailing blocks
// with block_expert == E, which names no expert: the Pallas index map
// clamps it, this kernel returns at once for any block without a real
// row, so it never reads past w, never reads a weight tile for padding,
// and writes only real rows (the caller gathers exactly those back).
//
// Bound on this card: bytes, at decode and at prefill. At decode 16
// routed rows touch at most 16 experts and the function must read each
// of their (d, f) matrices once (~92 MB at qwen2-moe's 2048 x 1408, ~27
// us at 3.35 TB/s) for a few operations per byte. A 1024-token prefill
// (4,096 rows over 60 experts) does ~23.6 GFLOP (~24 us of bf16 tensor
// cores) but must still read all 60 matrices, ~346 MB (~103 us). So the
// weight has to stream from HBM at full rate in both cases, and the
// products must keep up at prefill. Two bodies, chosen by dtype alone:
//
// * bf16: moe_gemm_mma, on the tensor cores with warp-level
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (not wgmma), the
//   primitives of mma.cuh. One CTA of 8 warps per (128-row tile,
//   128-column tile), the block index fastest in the grid. A tile is one
//   block or two blocks of one expert: the blocks of an expert's group
//   pair up from its first (each warp finds the group's start with a
//   ballot over block_expert), the CTA of an even position covers the
//   next block too and the CTA of an odd one returns, so a 68-row expert
//   (4,096 rows over 60 experts) streams its weight tile into one CTA,
//   not two. Each warp owns 32 rows (two m16 slices) by 64 columns (eight
//   n8 tiles). d is walked in 64-deep stages through a ring of three
//   16-byte cp.async stages in dynamic shared memory (107.5 KB, two CTAs
//   an SM), one barrier a stage; rows are padded by 16 bytes so ldmatrix
//   (A) and ldmatrix.trans (B, the weight's k-by-n rows) read without
//   bank conflicts. The copy loads only the m16 slices that hold a real
//   row, zero-fills the rows past the real ones within them and the
//   ragged k and n edges; a slice without a real row issues no ldmatrix
//   and no MMA. So a decode block (one or two rows) costs one slice of
//   MMAs and its time is the weight tile's stream. Where d, f or a
//   pointer's alignment rules out whole 16-byte runs, that operand is
//   loaded element by element into the same stage. The f32 sums are
//   rounded once to bf16 and stored straight from the accumulators, two
//   columns a store, real rows only.
//   A row's result does not depend on the rows it is sorted with: each
//   output element of mma.sync reads only its own row of A, every row
//   walks k in the same 16-deep steps from 0 to d whatever tile, slice or
//   position it lands in, and there is no split-K and no atomic. bf16 x
//   bf16 products are exact in f32, so the body differs from the plain
//   version only in the order of the f32 sums. There is no separate
//   decode body: a CUDA-core body chosen by the row count would give a
//   decode row other bits than the same row in a prefill batch.
//   Measured on an H100 SXM at 700 W (python -m
//   repro_torch.bench.moe_gemm, qwen2-moe's 2048 -> 1408, 60 experts, L2
//   flushed): 0.185 ms at 4,096 rows and 0.047 ms at 16 rows (the f32
//   CUDA-core loop it replaced: 1.52 and 0.31; torch.bmm over the
//   present experts: 0.137 and 0.045). The copies set the pace: without
//   the MMAs the kernel took 0.183 ms, without the copies 0.102. Tiles of
//   one block took 0.215 ms at prefill (the same at decode); 64-column
//   tiles 0.20-0.24 ms at prefill and up to 0.062 at decode; warps of 64
//   x 32 0.187; a 4-deep ring 0.052 ms at decode against 0.047; one
//   Hopper bulk copy (cp.async.bulk on an mbarrier) a tile row, for the
//   16-byte cp.async, 0.52 and 0.11 ms; the column tile fastest in the
//   grid 2-6 % faster at prefill, 3 % slower at decode.
// * f32: moe_gemm_kernel on the f32 CUDA cores (a single bf16 rounding
//   of an f32 operand breaks the f32 bar, and exact bf16 pieces of both
//   operands take six or more products). One block of 256 threads per
//   (64-row block, 64-column tile), d in 64-deep stages through shared
//   memory (x stored k-major so a thread's 4 rows are one broadcast
//   read, the weight row-major so its 4 columns are neighbours), 4 x 4
//   outputs a thread; only threads that own a real row multiply. A row's
//   sum runs over k in order 0..d-1 here too.
#include "common.cuh"
#include "mma.cuh"
#include "plan.cuh"

namespace {

constexpr int BM = 64;  // rows per block of the sorted layout

// ---------------------------------------------------------------------------
// f32: the CUDA-core body
// ---------------------------------------------------------------------------
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core body
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int MMA_THREADS = 256;  // 8 warps
constexpr int MMA_ROWS = 2 * BM;  // rows a CTA: up to two blocks of one expert
constexpr int MMA_BN = 128;       // output columns a CTA
constexpr int WARPS_M = 4;        // warps along the rows
constexpr int WARPS_N = MMA_THREADS / 32 / WARPS_M;
constexpr int WMT = MMA_ROWS / WARPS_M / 16;  // m16 slices a warp
constexpr int WNT = MMA_BN / WARPS_N / 8;     // n8 tiles a warp
constexpr int MMA_BK = 64;        // d per stage
constexpr int MMA_STAGES = 3;     // depth of the cp.async ring
constexpr int XLD = MMA_BK + 8;   // padded x row, elements
constexpr int WLD = MMA_BN + 8;   // padded weight row, elements
constexpr int X_ELEMS = MMA_ROWS * XLD;
constexpr int W_ELEMS = MMA_BK * WLD;
constexpr size_t MMA_SMEM = sizeof(bf16) * MMA_STAGES * (X_ELEMS + W_ELEMS);
static_assert(WMT >= 1 && WNT % 2 == 0, "warp tile");

__global__ void __launch_bounds__(MMA_THREADS, 2)
moe_gemm_mma(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const int* __restrict__ block_expert,
             const int* __restrict__ block_rows, bf16* __restrict__ out,
             int nb, int d, int f, int E, bool xvec, bool wvec, bool ovec) {
  const int blk = blockIdx.x;
  const int e = block_expert[blk];
  int nrows = block_rows[blk];
  if (nrows <= 0 || e < 0 || e >= E) return;  // trailing or empty block
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Pair the blocks of each expert's group from its first: the CTA of
  // an even position in the group covers the next block too, the CTA of
  // an odd position returns. Every warp finds the group's first block
  // itself, 32 blocks a step.
  int s = blk;
  for (;;) {
    const int i = s - 1 - lane;
    const unsigned m =
        __ballot_sync(0xffffffffu, i < 0 || block_expert[i] != e);
    if (m) {
      s -= __ffs(m) - 1;
      break;
    }
    s -= 32;
  }
  if ((blk - s) & 1) return;
  if (blk + 1 < nb && block_expert[blk + 1] == e)
    nrows += block_rows[blk + 1];  // block blk is full: not the last

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][ROWS][XLD]
  bf16* ws = xs + MMA_STAGES * X_ELEMS;          // [STAGES][BK][WLD]

  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / WARPS_N) * WMT * 16;
  const int wn0 = (warp % WARPS_N) * WNT * 8;
  const int n0 = blockIdx.y * MMA_BN;
  // rows of the m16 slices that hold a real row
  const int live = min(MMA_ROWS, (nrows + 15) & ~15);
  const bf16* xb = x + (long long)blk * BM * d;
  const bf16* we = w + (long long)e * d * f;
  const int n_k = (d + MMA_BK - 1) / MMA_BK;
  const bf16 zero = __float2bfloat16(0.f);

  auto load_stage = [&](int kt, int st) {
    const int k0 = kt * MMA_BK;
    bf16* xd = xs + st * X_ELEMS;
    for (int c = tid; c < live * (MMA_BK / 8); c += MMA_THREADS) {
      const int r = c / (MMA_BK / 8), kc = (c % (MMA_BK / 8)) * 8;
      const int kg = k0 + kc;
      bf16* dst = xd + r * XLD + kc;
      const bf16* src = xb + (long long)r * d + kg;
      if (xvec) {
        const bool ok = r < nrows && kg < d;
        cp_async16(smem_addr(dst), ok ? src : xb, ok);
      } else {
        for (int i = 0; i < 8; ++i)
          dst[i] = (r < nrows && kg + i < d) ? src[i] : zero;
      }
    }
    bf16* wd = ws + st * W_ELEMS;
    for (int c = tid; c < MMA_BK * (MMA_BN / 8); c += MMA_THREADS) {
      const int r = c / (MMA_BN / 8), nc = (c % (MMA_BN / 8)) * 8;
      const int kg = k0 + r, ng = n0 + nc;
      bf16* dst = wd + r * WLD + nc;
      const bf16* src = we + (long long)kg * f + ng;
      if (wvec) {
        const bool ok = kg < d && ng < f;
        cp_async16(smem_addr(dst), ok ? src : we, ok);
      } else {
        for (int i = 0; i < 8; ++i)
          dst[i] = (kg < d && ng + i < f) ? src[i] : zero;
      }
    }
  };

  float acc[WMT][WNT][4];
#pragma unroll
  for (int mt = 0; mt < WMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < WNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  // the m16 slices of this warp that hold a real row (warp-uniform)
  bool m_live[WMT];
#pragma unroll
  for (int mt = 0; mt < WMT; ++mt) m_live[mt] = wm0 + mt * 16 < nrows;

#pragma unroll
  for (int st = 0; st < MMA_STAGES - 1; ++st) {
    if (st < n_k) load_stage(st, st);
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
    if (!m_live[0]) continue;  // no real row in this warp's rows
    const bf16* xt = xs + st * X_ELEMS;
    const bf16* wt = ws + st * W_ELEMS;
#pragma unroll
    for (int kk = 0; kk < MMA_BK; kk += 16) {
      // the weight's k-by-n rows, transposed: matrices 0/1 are k 0-7 /
      // 8-15 of 8 columns, matrices 2/3 those of the next 8
      uint32_t b[WNT][2];
#pragma unroll
      for (int h = 0; h < WNT / 2; ++h) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem_addr(wt + (kk + (lane & 7) +
                                             ((lane >> 3) & 1) * 8) * WLD +
                                       wn0 + 16 * h + (lane >> 4) * 8));
        b[2 * h][0] = r[0];
        b[2 * h][1] = r[1];
        b[2 * h + 1][0] = r[2];
        b[2 * h + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < WMT; ++mt) {
        if (!m_live[mt]) continue;
        uint32_t a[4];
        ldmatrix_x4(a, smem_addr(xt + (wm0 + mt * 16 + (lane & 15)) * XLD +
                                 kk + (lane >> 4) * 8));
#pragma unroll
        for (int nt = 0; nt < WNT; ++nt)
          mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: real rows only, rounded once, columns 2t and 2t + 1 of
  // each n8 tile in one store
#pragma unroll
  for (int mt = 0; mt < WMT; ++mt) {
    if (!m_live[mt]) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm0 + mt * 16 + g + 8 * half;
      if (r >= nrows) continue;
      bf16* orow = out + ((long long)blk * BM + r) * f;
#pragma unroll
      for (int nt = 0; nt < WNT; ++nt) {
        const int n = n0 + wn0 + nt * 8 + 2 * t;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (ovec) {  // f even: the pair is whole or wholly outside
          if (n < f)
            *reinterpret_cast<uint32_t*>(orow + n) = pack_bf16(v0, v1);
        } else {
          if (n < f) orow[n] = __float2bfloat16(v0);
          if (n + 1 < f) orow[n + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launch plans and the body choice
// ---------------------------------------------------------------------------
// f32: one block of NT per (64-row block, BN columns).
RtLaunch plan_simt(int nb, int f) {
  return rt_plan((const void*)moe_gemm_kernel<float>,
                 dim3((unsigned)nb, (unsigned)((f + BN - 1) / BN)), dim3(NT),
                 0, "moe_gemm_kernel<f32>");
}

// bf16: one CTA of MMA_THREADS per (64-row block, MMA_BN columns); the CTA
// of an odd position in its expert's group returns, the even one covers
// the next block of the group too.
RtLaunch plan_mma(int nb, int f) {
  return rt_plan((const void*)moe_gemm_mma,
                 dim3((unsigned)nb, (unsigned)((f + MMA_BN - 1) / MMA_BN)),
                 dim3(MMA_THREADS), MMA_SMEM, "moe_gemm_mma");
}

using SimtKernel = void (*)(const float*, const float*, const int*,
                            const int*, float*, int, int, int);
using MmaKernel = void (*)(const bf16*, const bf16*, const int*, const int*,
                           bf16*, int, int, int, int, bool, bool, bool);

// The body is chosen by dtype alone; handed to op with its plan.
template <class Op>
int dispatch(int dtype, int nb, int f, const Op& op) {
  if (dtype == RT_BF16) return op(plan_mma(nb, f), MmaKernel(&moe_gemm_mma));
  if (dtype == RT_F32)
    return op(plan_simt(nb, f), SimtKernel(&moe_gemm_kernel<float>));
  return static_cast<int>(cudaErrorInvalidValue);
}

struct Run {
  const void *x, *w, *be, *rows;
  void* out;
  int nb, d, f, E;
  cudaStream_t s;

  int operator()(const RtLaunch& p, SimtKernel kern) const {
    kern<<<rt_grid(p), rt_block(p), p.smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const int*>(be), static_cast<const int*>(rows),
        static_cast<float*>(out), d, f, E);
    return static_cast<int>(cudaGetLastError());
  }
  int operator()(const RtLaunch& p, MmaKernel kern) const {
    const int err = rt_smem_optin(p);
    if (err) return err;
    const bool xvec = d % 8 == 0 && rt_aligned16(x);
    const bool wvec = f % 8 == 0 && rt_aligned16(w);
    const bool ovec =
        f % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
    kern<<<rt_grid(p), rt_block(p), p.smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w),
        static_cast<const int*>(be), static_cast<const int*>(rows),
        static_cast<bf16*>(out), nb, d, f, E, xvec, wvec, ovec);
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

extern "C" int rt_moe_gemm(const void* x, const void* w,
                           const void* block_expert, const void* block_rows,
                           void* out, int nb, int d, int f, int E, int dtype,
                           void* stream) {
  if (nb <= 0 || f <= 0) return 0;
  return dispatch(dtype, nb, f,
                  Run{x, w, block_expert, block_rows, out, nb, d, f, E,
                      static_cast<cudaStream_t>(stream)});
}

// The launch rt_moe_gemm makes: the count, at most cap written to out; a
// negative CUDA error code where it would refuse.
extern "C" int rt_moe_gemm_plan(int nb, int f, int dtype, RtLaunch* out,
                                int cap) {
  if (nb <= 0 || f <= 0) return 0;
  RtPlanSink sink{out, cap, 0};
  const int e = dispatch(dtype, nb, f, RecordPlan{&sink});
  return e ? -e : sink.n;
}
