// Chunked SSD (Mamba-2 state-space duality) scan for Hopper.
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_scan_pallas (body
// _ssd_kernel). Per (batch, head) and chunk of L positions, with
// a = cumsum(dt * A) inside the chunk and h the state carried from the
// previous chunks:
//   y[t]  = sum_{s<=t} (C_t . B_s) exp(a_t - a_s) dt_s x_s     (diagonal)
//         + exp(a_t) C_t h^T                                  (carried)
//   h    <- exp(a_{L-1}) h + sum_s exp(a_{L-1} - a_s) dt_s x_s B_s^T
// Positions past S have dt = 0 and x = B = C = 0, as the reference pads.
//
// Layouts are the reference's: x, y (b, S, nh, hp) in x's dtype; dt
// (b, S, nh) f32; A (nh,) f32; B, C (b, S, nh, N) in x's dtype; the final
// state (b, nh, hp, N) f32. All contiguous. ``ws`` is an f32 workspace of
// b * nh * nc * (hp * N + L) floats (nc = ceil(S / L)): each chunk's
// state, then each chunk's cumulative sum.
//
// Bound on this card: bytes at mamba2-1.3b's prefill (S 1024, chunk 256,
// 64 heads of 64, state 128): ~53 MB of inputs and outputs against ~5.4
// GFLOP of causal products, which the bf16 tensor cores would do in a
// third of the time the bytes take; on the f32 CUDA cores, which this
// kernel uses, the products take 5x the bytes' time.
//
// Design: the TPU walks the chunks in order on one core; here the chunks
// run in parallel, in Mamba-2's own GPU decomposition, three launches:
//   1. ssd_chunk_state: one block per (sequence * head, chunk, slice
//      of hp): the chunk's cumulative sum (chunk_cumsum), kept in the
//      workspace, and the chunk's own state sum_s w_s x_s B_s^T, w_s =
//      dt_s exp(a_{L-1} - a_s), into the workspace;
//   2. ssd_state_pass: one thread per (sequence * head, 8 state elements)
//      walks the chunks, h_c = exp(a_{L-1,c}) h_{c-1} + state_c, leaving
//      in the workspace the state each chunk starts from, and writes the
//      final state;
//   3. ssd_chunk_out: one block per (sequence * head, chunk, slice of
//      hp): the diagonal and carried terms, summed in f32 and rounded to
//      x's dtype once.
// Steps 1 and 3 run on the CUDA cores: 256 threads, 64-row sub-tiles
// brought into shared memory by 16-byte loads, read back as float4; step
// 3 takes a 64 x 64 score tile at a time, each thread 4 x 4 scores and 4
// rows of outputs, and a block takes all of a head's hp (up to 64) so
// the scores are formed once.
//
// Precision: every sum is the plain version's to the bit where PyTorch's
// own kernels are sequential. Each dot product (C.B over n, M.x over s,
// C.h over n, (w x).B over s) is one fma chain in index order, the order
// of cuBLAS's f32 GEMMs behind the plain version's einsums; the
// cumulative sum is one thread's chain of f32 adds of the f32 products dt
// * A, as torch.cumsum walks a dimension that is not the innermost; the
// pass and the decays multiply and add apart, as the plain version's
// tensor operations round. On mamba2-1.3b's full-depth parity run this
// gives the plain version's outputs bit for bit, which that bar needs:
// a tensor-core scan, whose sums round elsewhere, moved ~1e-4 of y's
// bf16 values one ulp and the logits 0.64-0.95 against the bar of 0.25
// (PERF.md §6).
#include "common.cuh"
#include "plan.cuh"

namespace {

__device__ __forceinline__ long long row_of(int bi, int pos, int S, int nh,
                                            int h) {
  return ((long long)bi * S + pos) * nh + h;
}

// a[t] = sum_{u<=t} dt_u * A over the chunk's L positions (dt 0 past S),
// into s_acs; dt into s_dt. The plain version's torch.cumsum runs over a
// dimension that is not the innermost one, which PyTorch's CUDA scan walks
// one column a thread, in order; so one thread walks it here too, adding
// the f32 products dt_u * A (rounded apart, as the plain version forms
// them) in order: the decays then equal the plain version's bit for bit.
// A parallel scan, in f32 or in f64, gives decays a few ulps off theirs,
// and on mamba2-1.3b's full-depth parity run such differences reach the
// logits (PERF.md §6). The loop is ~L dependent adds. Ends with a
// barrier.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt,
                                             float a_h, int bi, int h, int c0,
                                             int L, int S, int nh,
                                             float* s_acs, float* s_dt) {
  for (int t = threadIdx.x; t < L; t += blockDim.x) {
    const int pos = c0 + t;
    s_dt[t] = pos < S ? dt[row_of(bi, pos, S, nh, h)] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int t = 0; t < L; ++t) {
      run = __fadd_rn(run, __fmul_rn(s_dt[t], a_h));
      s_acs[t] = run;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Step 2: the pass over chunks
// ---------------------------------------------------------------------------
constexpr int PASS_THREADS = 64;

// Each thread owns 8 consecutive state elements of every chunk and
// replaces chunk c's own state by the state chunk c starts from, h_c =
// h_{c-1} exp(a_{L-1,c-1}) + state_{c-1}, multiplied and added apart (no
// fma), as the plain version's two tensor operations round.
__global__ void __launch_bounds__(PASS_THREADS)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ acs,
               float* __restrict__ hout, int hpN, int L, int nc) {
  const int bh = blockIdx.x;
  const int e = (blockIdx.y * PASS_THREADS + threadIdx.x) * 8;
  if (e >= hpN) return;
  float4* st = reinterpret_cast<float4*>(states + (long long)bh * nc * hpN + e);
  const long long cstep = hpN / 4;        // float4s per chunk
  const float* a_last = acs + (long long)bh * nc * L + (L - 1);
  float h[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float4 n0 = st[0], n1 = st[1];
  float na = a_last[0];
  for (int c = 0; c < nc; ++c) {
    const float s[8] = {n0.x, n0.y, n0.z, n0.w, n1.x, n1.y, n1.z, n1.w};
    const float a = na;
    if (c + 1 < nc) {
      n0 = st[(c + 1) * cstep];
      n1 = st[(c + 1) * cstep + 1];
      na = a_last[(long long)(c + 1) * L];
    }
    float4* dst = st + c * cstep;
    dst[0] = make_float4(h[0], h[1], h[2], h[3]);
    dst[1] = make_float4(h[4], h[5], h[6], h[7]);
    const float dec = expf(a);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = __fadd_rn(__fmul_rn(h[i], dec), s[i]);
  }
  float4* out = reinterpret_cast<float4*>(hout + (long long)bh * hpN + e);
  out[0] = make_float4(h[0], h[1], h[2], h[3]);
  out[1] = make_float4(h[4], h[5], h[6], h[7]);
}

// ---------------------------------------------------------------------------
// Steps 1 and 3 on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int TS = 64;        // sub-tile rows (t and s)
constexpr int LS = TS + 4;    // a padded 64-wide row: 16-byte aligned
constexpr int THREADS = 256;  // 16 x 16 threads

// Rows [r0, r0 + TS) of columns [q0, q0 + Q) of a (b, S, nh, W) tensor
// for (bi, h), zero past the chunk (L) or the sequence (S), widened to f32
// and handed to put(r, q, v). With ``vec`` (W and q0 multiples of 16
// bytes' worth of elements, the tensor 16-byte aligned) each thread loads
// 16 bytes at a time.
template <typename T, typename Put>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int bi,
                                           int h, int c0, int r0, int q0,
                                           int Q, int W, int L, int S,
                                           int nh, bool vec, Put put) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    const int QV = Q / V;
    for (int i = threadIdx.x; i < TS * QV; i += THREADS) {
      const int r = i / QV, q = (i % QV) * V;
      const int t = r0 + r, pos = c0 + t;
      alignas(16) T e[V];
      if (t < L && pos < S) {
        *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(
            src + row_of(bi, pos, S, nh, h) * W + q0 + q);
#pragma unroll
        for (int k = 0; k < V; ++k) put(r, q + k, to_float(e[k]));
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) put(r, q + k, 0.f);
      }
    }
  } else {
    for (int i = threadIdx.x; i < TS * Q; i += THREADS) {
      const int r = i / Q, q = i % Q;
      const int t = r0 + r, pos = c0 + t;
      float v = 0.f;
      if (t < L && pos < S)
        v = to_float(src[row_of(bi, pos, S, nh, h) * W + q0 + q]);
      put(r, q, v);
    }
  }
}

template <typename T>
__device__ __forceinline__ bool rows16(const T* p, int W, int q0) {
  constexpr int V = 16 / sizeof(T);
  return W % V == 0 && q0 % V == 0 &&
         reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Rows [r0, r0 + TS) of a (b, S, nh, N) tensor into dst[n * LS + r]
// (n-major).
template <typename T>
__device__ __forceinline__ void stage_nmajor(
    const T* __restrict__ src, float* dst, int bi, int h, int c0, int r0,
    int L, int S, int nh, int N) {
  stage_rows(src, bi, h, c0, r0, 0, N, N, L, S, nh, rows16(src, N, 0),
             [&](int r, int n, float v) { dst[n * LS + r] = v; });
}

// Rows [r0, r0 + TS) of x's columns [p0, p0 + PT) into dst[r * PT + p].
template <typename T, int PT>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, float* dst,
                                        int bi, int h, int c0, int r0, int p0,
                                        int L, int S, int nh, int hp) {
  stage_rows(x, bi, h, c0, r0, p0, PT, hp, L, S, nh, rows16(x, hp, p0),
             [&](int r, int p, float v) { dst[r * PT + p] = v; });
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

template <int PT>
__host__ __device__ constexpr long long state_floats(int L, int N) {
  // s_acs, s_w (L each), Bs (TS x (N4 + 4)), xw (TS x PT)
  return 2LL * L + (long long)TS * (round4(N) + 4) + TS * PT;
}

template <int PT>
__host__ __device__ constexpr long long out_floats(int L, int N) {
  // s_acs, s_dt (L each), Ct and Bt (N x LS each; Bt takes the carried
  // state, N x (PT + 4), while the carried term is formed), xs (TS x PT),
  // Ms (TS x LS)
  return 2LL * L + 2LL * N * LS + TS * PT + TS * LS;
}

// Step 1. Grid (b * nh, nc, hp / PT). Each thread owns GPT groups of 4 x
// 4 state elements (p, n) at a time; each is one fma chain over s in
// order.
template <typename T, int PPT>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   float* __restrict__ states, float* __restrict__ acs,
                   int S, int nh, int hp, int N, int L, int nc) {
  constexpr int PT = 16 * PPT;
  const int bh = blockIdx.x, bi = bh / nh, h = bh % nh;
  const int c = blockIdx.y, c0 = c * L, p0 = blockIdx.z * PT;
  const int tid = threadIdx.x;
  const int N4 = round4(N), LB = N4 + 4;        // a row of Bs

  extern __shared__ __align__(16) float sm[];
  float* s_acs = sm;
  float* s_w = s_acs + L;
  float* Bs = s_w + L;                          // (s, n), s-major
  float* xw = Bs + TS * LB;                     // (s, p): x_s * w_s
  // L is any positive int: realign the tiles to 16 bytes
  Bs = reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(Bs) + 15) &
                                ~uintptr_t(15));
  xw = Bs + TS * LB;

  chunk_cumsum(dt, A[h], bi, h, c0, L, S, nh, s_acs, s_w);
  const float a_last = s_acs[L - 1];
  if (blockIdx.z == 0) {
    float* dst = acs + ((long long)bh * nc + c) * L;
    for (int i = tid; i < L; i += THREADS) dst[i] = s_acs[i];
  }
  for (int i = tid; i < L; i += THREADS)
    s_w[i] = __fmul_rn(s_w[i], expf(a_last - s_acs[i]));

  constexpr int GPT = PPT >= 4 ? 2 : 1;         // PT 64, N 128: one pass
  const int groups = (PT / 4) * (N4 / 4);
  float* out = states + (((long long)bh * nc + c) * hp + p0) * N;
  const int nsub = (L + TS - 1) / TS;
  for (int g0 = 0; g0 < groups; g0 += GPT * THREADS) {
    float acc[GPT][4][4];
#pragma unroll
    for (int q = 0; q < GPT; ++q)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[q][a][b] = 0.f;
    for (int si = 0; si < nsub; ++si) {
      const int s0 = si * TS;
      __syncthreads();  // s_w written / Bs, xw free
      for (int i = tid; i < TS * (N4 - N); i += THREADS)   // pad columns
        Bs[(i / (N4 - N)) * LB + N + i % (N4 - N)] = 0.f;
      stage_rows(Bm, bi, h, c0, s0, 0, N, N, L, S, nh, rows16(Bm, N, 0),
                 [&](int r, int n, float v) { Bs[r * LB + n] = v; });
      stage_rows(x, bi, h, c0, s0, p0, PT, hp, L, S, nh, rows16(x, hp, p0),
                 [&](int r, int p, float v) {
                   xw[r * PT + p] = __fmul_rn(v, s_w[min(s0 + r, L - 1)]);
                 });
      __syncthreads();
      const int ns = min(TS, L - s0);
#pragma unroll
      for (int q = 0; q < GPT; ++q) {
        const int gi = g0 + q * THREADS + tid;
        if (gi >= groups) continue;
        const int pg = (gi / (N4 / 4)) * 4, ng = (gi % (N4 / 4)) * 4;
        for (int s = 0; s < ns; ++s) {
          const float4 xv = *reinterpret_cast<const float4*>(xw + s * PT + pg);
          const float4 bv = *reinterpret_cast<const float4*>(Bs + s * LB + ng);
          const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
          const float ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[q][a][b] = fmaf(xa[a], ba[b], acc[q][a][b]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < GPT; ++q) {
      const int gi = g0 + q * THREADS + tid;
      if (gi >= groups) continue;
      const int pg = (gi / (N4 / 4)) * 4, ng = (gi % (N4 / 4)) * 4;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (ng + b < N) out[(pg + a) * N + ng + b] = acc[q][a][b];
    }
  }
}

// Step 3. Grid (b * nh, nc, hp / PT). Thread (ty, tx) owns t rows 4 ty ..
// and score columns 4 tx .. of each 64 x 64 tile, and outputs (t, p) for
// p = tx * PPT ..; every sum is one fma chain in index order.
template <typename T, int PPT>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_out(const T* __restrict__ x, const float* __restrict__ dt,
                 const T* __restrict__ Bm, const T* __restrict__ Cm,
                 const float* __restrict__ hprev,
                 const float* __restrict__ acs, T* __restrict__ y, int S,
                 int nh, int hp, int N, int L, int nc) {
  constexpr int PT = 16 * PPT;
  const int bh = blockIdx.x, bi = bh / nh, h = bh % nh;
  const int c = blockIdx.y, c0 = c * L, p0 = blockIdx.z * PT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  extern __shared__ __align__(16) float sm[];
  float* s_acs = sm;
  float* s_dt = s_acs + L;
  // L is any positive int: realign the tiles to 16 bytes
  float* Ct = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(s_dt + L) + 15) & ~uintptr_t(15));
  float* Bt = Ct + N * LS;
  float* xs = Bt + N * LS;
  float* Ms = xs + TS * PT;
  float* hs = Bt;                 // (n, p), while the carried term forms

  const float* acs_c = acs + ((long long)bh * nc + c) * L;
  for (int t = tid; t < L; t += THREADS) {
    const int pos = c0 + t;
    s_acs[t] = acs_c[t];
    s_dt[t] = pos < S ? dt[row_of(bi, pos, S, nh, h)] : 0.f;
  }
  const float* h_c = hprev + (((long long)bh * nc + c) * hp + p0) * N;

  const int nsub = (L + TS - 1) / TS;
  for (int ti = 0; ti < nsub; ++ti) {
    const int t0 = ti * TS;
    if (c0 + t0 >= S) break;
    __syncthreads();  // s_acs loaded; Ct, Bt free
    stage_nmajor(Cm, Ct, bi, h, c0, t0, L, S, nh, N);
    for (int i = tid; i < PT * N; i += THREADS)
      hs[(i % N) * (PT + 4) + i / N] = h_c[i];
    __syncthreads();
    // carried term: C_t . h_p over n, then exp(a_t)
    float off[4][PPT], dia[4][PPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < PPT; ++j) off[i][j] = dia[i][j] = 0.f;
    for (int n = 0; n < N; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(Ct + n * LS + ty * 4);
      const float ca[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const float hv = hs[n * (PT + 4) + tx * PPT + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) off[i][j] = fmaf(ca[i], hv, off[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gt = t0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < PPT; ++j)
        off[i][j] = gt < L ? off[i][j] * expf(s_acs[gt]) : 0.f;
    }

    for (int si = 0; si <= ti; ++si) {
      const int s0 = si * TS;
      __syncthreads();  // hs read / Bt, xs, Ms free
      stage_nmajor(Bm, Bt, bi, h, c0, s0, L, S, nh, N);
      stage_x<T, PT>(x, xs, bi, h, c0, s0, p0, L, S, nh, hp);
      __syncthreads();
      // scores M[t][s] = (C_t . B_s) exp(a_t - a_s) dt_s, s <= t
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float4 av = *reinterpret_cast<const float4*>(Ct + n * LS + ty * 4);
        const float4 bv = *reinterpret_cast<const float4*>(Bt + n * LS + tx * 4);
        const float a[4] = {av.x, av.y, av.z, av.w};
        const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gt = t0 + ty * 4 + i;
        float m[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gs = s0 + tx * 4 + j;
          m[j] = 0.f;
          if (gs <= gt && gt < L)
            m[j] = __fmul_rn(__fmul_rn(sc[i][j], expf(s_acs[gt] - s_acs[gs])),
                             s_dt[gs]);
        }
        *reinterpret_cast<float4*>(Ms + (ty * 4 + i) * LS + tx * 4) =
            make_float4(m[0], m[1], m[2], m[3]);
      }
      __syncthreads();
      // diagonal term: M_t . x_p over s; on the diagonal tile the terms
      // past this thread's last row are exact zeros and are skipped
      const int s_end = si == ti ? ty * 4 + 4 : TS;
      for (int s4 = 0; s4 < s_end; s4 += 4) {
        float mr[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 mv =
              *reinterpret_cast<const float4*>(Ms + (ty * 4 + i) * LS + s4);
          mr[i][0] = mv.x; mr[i][1] = mv.y; mr[i][2] = mv.z; mr[i][3] = mv.w;
        }
#pragma unroll
        for (int ss = 0; ss < 4; ++ss)
#pragma unroll
          for (int j = 0; j < PPT; ++j) {
            const float xv = xs[(s4 + ss) * PT + tx * PPT + j];
#pragma unroll
            for (int i = 0; i < 4; ++i) dia[i][j] = fmaf(mr[i][ss], xv, dia[i][j]);
          }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gt = t0 + ty * 4 + i, pos = c0 + gt;
      if (gt >= L || pos >= S) continue;
      T* yrow = y + row_of(bi, pos, S, nh, h) * hp + p0;
#pragma unroll
      for (int j = 0; j < PPT; ++j)
        yrow[tx * PPT + j] = from_float<T>(dia[i][j] + off[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------
constexpr size_t SMEM_MAX = 232448;

// Steps 1 and 3: one block of THREADS per (b * nh, chunk, slice of PT
// columns of hp), the tiles in dynamic shared memory.
template <typename T, int PPT>
RtLaunch plan_state(int b, int nh, int hp, int N, int L, int nc) {
  constexpr int PT = 16 * PPT;
  return rt_plan((const void*)ssd_chunk_state<T, PPT>,
                 dim3((unsigned)(b * nh), (unsigned)nc, (unsigned)(hp / PT)),
                 dim3(THREADS), sizeof(float) * (state_floats<PT>(L, N) + 4),
                 "ssd_chunk_state<%s,%d>", rt_tname<T>(), PPT);
}

template <typename T, int PPT>
RtLaunch plan_out(int b, int nh, int hp, int N, int L, int nc) {
  constexpr int PT = 16 * PPT;
  return rt_plan((const void*)ssd_chunk_out<T, PPT>,
                 dim3((unsigned)(b * nh), (unsigned)nc, (unsigned)(hp / PT)),
                 dim3(THREADS), sizeof(float) * (out_floats<PT>(L, N) + 4),
                 "ssd_chunk_out<%s,%d>", rt_tname<T>(), PPT);
}

// Step 2: one thread per (b * nh, 8 state elements).
RtLaunch plan_pass(int b, int nh, int hp, int N) {
  const int hpN = hp * N;                 // a multiple of 16
  return rt_plan((const void*)ssd_state_pass,
                 dim3((unsigned)(b * nh),
                      (unsigned)((hpN / 8 + PASS_THREADS - 1) /
                                 PASS_THREADS)),
                 dim3(PASS_THREADS), 0, "ssd_state_pass");
}

// The three launches of a call, handed to op with steps 1 and 3's
// kernels: 64 columns a block where hp allows, else 32, else 16. A block
// past the card's shared memory is refused.
template <typename T, int PPT, class Op>
int steps(int b, int nh, int hp, int N, int L, int nc, const Op& op) {
  const RtLaunch st = plan_state<T, PPT>(b, nh, hp, N, L, nc);
  const RtLaunch out = plan_out<T, PPT>(b, nh, hp, N, L, nc);
  if (st.smem > SMEM_MAX || out.smem > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  return op(st, &ssd_chunk_state<T, PPT>, plan_pass(b, nh, hp, N), out,
            &ssd_chunk_out<T, PPT>);
}

template <typename T, class Op>
int dispatch(int b, int nh, int hp, int N, int L, int nc, const Op& op) {
  if (hp % 64 == 0) return steps<T, 4>(b, nh, hp, N, L, nc, op);
  if (hp % 32 == 0) return steps<T, 2>(b, nh, hp, N, L, nc, op);
  return steps<T, 1>(b, nh, hp, N, L, nc, op);
}

template <typename T>
using StateKernel = void (*)(const T*, const float*, const float*, const T*,
                             float*, float*, int, int, int, int, int, int);
template <typename T>
using OutKernel = void (*)(const T*, const float*, const T*, const T*,
                           const float*, const float*, T*, int, int, int, int,
                           int, int);

template <typename T>
struct Run {
  const void *x, *dt, *A, *B, *C;
  void *y, *h;
  float *states, *acs;
  int S, nh, hp, N, L, nc;
  cudaStream_t s;

  int operator()(const RtLaunch& ps, StateKernel<T> kstate,
                 const RtLaunch& pp, const RtLaunch& po,
                 OutKernel<T> kout) const {
    const T* xt = static_cast<const T*>(x);
    const T* Bt = static_cast<const T*>(B);
    const float* dtf = static_cast<const float*>(dt);
    int e = rt_smem_optin(ps);
    if (e) return e;
    kstate<<<rt_grid(ps), rt_block(ps), ps.smem, s>>>(
        xt, dtf, static_cast<const float*>(A), Bt, states, acs, S, nh, hp, N,
        L, nc);
    e = static_cast<int>(cudaGetLastError());
    if (e) return e;
    ssd_state_pass<<<rt_grid(pp), rt_block(pp), pp.smem, s>>>(
        states, acs, static_cast<float*>(h), hp * N, L, nc);
    e = static_cast<int>(cudaGetLastError());
    if (e) return e;
    e = rt_smem_optin(po);
    if (e) return e;
    kout<<<rt_grid(po), rt_block(po), po.smem, s>>>(
        xt, dtf, Bt, static_cast<const T*>(C), states, acs,
        static_cast<T*>(y), S, nh, hp, N, L, nc);
    return static_cast<int>(cudaGetLastError());
  }
};

struct RecordPlan {
  RtPlanSink* sink;
  template <typename K1, typename K2>
  int operator()(const RtLaunch& ps, K1, const RtLaunch& pp,
                 const RtLaunch& po, K2) const {
    sink->add(ps);
    sink->add(pp);
    sink->add(po);
    return 0;
  }
};

}  // namespace

extern "C" int rt_ssd_scan(const void* x, const void* dt, const void* A,
                           const void* B, const void* C, void* y, void* h,
                           void* ws, int b, int S, int nh, int hp, int N,
                           int L, int dtype, void* stream) {
  if (b <= 0 || S <= 0 || nh <= 0) return 0;
  if (L <= 0 || N <= 0 || hp <= 0 || hp % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (S + L - 1) / L;
  // ws: the chunk states, then the chunks' cumulative sums
  float* states = static_cast<float*>(ws);
  float* acs = states + (long long)b * nh * nc * hp * N;
  if (dtype == RT_BF16)
    return dispatch<__nv_bfloat16>(
        b, nh, hp, N, L, nc,
        Run<__nv_bfloat16>{x, dt, A, B, C, y, h, states, acs, S, nh, hp, N,
                           L, nc, s});
  if (dtype == RT_F32)
    return dispatch<float>(b, nh, hp, N, L, nc,
                           Run<float>{x, dt, A, B, C, y, h, states, acs, S,
                                      nh, hp, N, L, nc, s});
  return static_cast<int>(cudaErrorInvalidValue);
}

// The three launches rt_ssd_scan makes: the count, at most cap written to
// out; a negative CUDA error code where it would refuse.
extern "C" int rt_ssd_scan_plan(int b, int S, int nh, int hp, int N, int L,
                                int dtype, RtLaunch* out, int cap) {
  if (b <= 0 || S <= 0 || nh <= 0) return 0;
  if (L <= 0 || N <= 0 || hp <= 0 || hp % 16)
    return -static_cast<int>(cudaErrorInvalidValue);
  const int nc = (S + L - 1) / L;
  RtPlanSink sink{out, cap, 0};
  const RecordPlan op{&sink};
  int e;
  if (dtype == RT_BF16)
    e = dispatch<__nv_bfloat16>(b, nh, hp, N, L, nc, op);
  else if (dtype == RT_F32)
    e = dispatch<float>(b, nh, hp, N, L, nc, op);
  else
    e = static_cast<int>(cudaErrorInvalidValue);
  return e ? -e : sink.n;
}
