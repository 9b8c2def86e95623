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
// state (b, nh, hp, N) f32. All contiguous.
//
// Bound on this card: operations. At mamba2-1.3b's prefill (S 1024,
// chunk 256, 64 heads of 64, N 128) the causal products need ~5.4 GFLOP
// per layer against ~42 MB of bf16 inputs, and this kernel computes in
// f32 on the CUDA cores (67 TFLOP/s), as the Pallas body computes in
// f32. Design: the TPU kernel holds a whole (L, L) decay matrix and
// (L, N) tiles in VMEM; at L 256 and N 128 that is more than a Hopper
// block's 227 KB. Here one block per (batch * head, 32-column slice of
// hp) walks the chunks in order (the sequential grid axis of the TPU
// becomes a loop) and keeps its slice of h (32 x N f32) in shared
// memory across chunks; h's rows are independent in hp, so the slices
// never talk. Inside a chunk, t and s run over 64-row sub-tiles: C and B
// sub-tiles are staged n-major (conflict-free padded stride), a 64 x 64
// score tile is formed, masked causally and by the decay, and applied to
// the x sub-tile. The diagonal and carried terms accumulate separately
// and are added last, and the state update sums the chunk's terms before
// adding the decayed h, in the plain version's order.
#include "common.cuh"

namespace {

constexpr int TS = 64;        // sub-tile rows (t and s)
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int HMAX = 32;      // state outputs per thread (PT * N <= 8192)

template <int PT>
__host__ __device__ constexpr long long smem_floats(int L, int N) {
  // s_acs, s_dt (L each), Ct, Bt (N x (TS+1) each), xs (TS x PT),
  // Ms (TS x (TS+1)), hs (PT x (N+1)), s_w (TS)
  return 2LL * L + 2LL * N * (TS + 1) + TS * PT + TS * (TS + 1) +
         (long long)PT * (N + 1) + TS;
}

// Stage rows [r0, r0 + TS) of a (b, S, nh, N) tensor for (bi, h) into
// dst[n * (TS + 1) + r], zero past the chunk (L) or the sequence (S).
template <typename T>
__device__ __forceinline__ void stage_nmajor(
    const T* __restrict__ src, float* dst, int bi, int h, int c0, int r0,
    int L, int S, int nh, int N) {
  for (int i = threadIdx.x; i < TS * N; i += THREADS) {
    const int r = i / N, n = i % N;
    const int t = r0 + r, pos = c0 + t;
    float v = 0.f;
    if (t < L && pos < S)
      v = to_float(src[(((long long)bi * S + pos) * nh + h) * N + n]);
    dst[n * (TS + 1) + r] = v;
  }
}

template <typename T, int PPT>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y,
           float* __restrict__ hout, int S, int nh, int hp, int N, int L) {
  constexpr int PT = 16 * PPT;
  const int bh = blockIdx.x, bi = bh / nh, h = bh % nh;
  const int p0 = blockIdx.y * PT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  extern __shared__ float sm[];
  float* s_acs = sm;
  float* s_dt = s_acs + L;
  float* Ct = s_dt + L;
  float* Bt = Ct + N * (TS + 1);
  float* xs = Bt + N * (TS + 1);
  float* Ms = xs + TS * PT;
  float* hs = Ms + TS * (TS + 1);
  float* s_w = hs + PT * (N + 1);

  const float a_h = A[h];
  for (int i = tid; i < PT * N; i += THREADS) hs[(i / N) * (N + 1) + i % N] = 0.f;

  const int nc = (S + L - 1) / L;
  const int nsub = (L + TS - 1) / TS;
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * L;
    __syncthreads();  // the previous chunk is done with s_dt / s_acs / hs
    for (int t = tid; t < L; t += THREADS) {
      const int pos = c0 + t;
      s_dt[t] = pos < S ? dt[((long long)bi * S + pos) * nh + h] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int t = 0; t < L; ++t) {
        run += s_dt[t] * a_h;
        s_acs[t] = run;
      }
    }
    __syncthreads();
    const float a_last = s_acs[L - 1];

    // ---- outputs of this chunk, 64 rows at a time -----------------------
    for (int ti = 0; ti < nsub; ++ti) {
      const int t0 = ti * TS;
      stage_nmajor(Cm, Ct, bi, h, c0, t0, L, S, nh, N);
      __syncthreads();
      float off[4][PPT], dia[4][PPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          float acc = 0.f;
          const int t = ty * 4 + i, p = tx * PPT + j;
          for (int n = 0; n < N; ++n)
            acc = fmaf(Ct[n * (TS + 1) + t], hs[p * (N + 1) + n], acc);
          const int gt = t0 + t;
          off[i][j] = gt < L ? acc * expf(s_acs[gt]) : 0.f;
          dia[i][j] = 0.f;
        }

      for (int si = 0; si <= ti; ++si) {
        const int s0 = si * TS;
        stage_nmajor(Bm, Bt, bi, h, c0, s0, L, S, nh, N);
        for (int i = tid; i < TS * PT; i += THREADS) {
          const int r = i / PT, p = i % PT;
          const int t = s0 + r, pos = c0 + t;
          float v = 0.f;
          if (t < L && pos < S)
            v = to_float(x[(((long long)bi * S + pos) * nh + h) * hp + p0 + p]);
          xs[i] = v;
        }
        __syncthreads();
        // scores M[t][s] = (C_t . B_s) exp(a_t - a_s) dt_s, s <= t
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = Ct[n * (TS + 1) + ty * 4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = Bt[n * (TS + 1) + tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], b[j], sc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int gt = t0 + ty * 4 + i, gs = s0 + tx * 4 + j;
            float m = 0.f;
            if (gs <= gt && gt < L)
              m = sc[i][j] * expf(s_acs[gt] - s_acs[gs]) * s_dt[gs];
            Ms[(ty * 4 + i) * (TS + 1) + tx * 4 + j] = m;
          }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PPT; ++j) {
            float acc = dia[i][j];
            const float* mrow = Ms + (ty * 4 + i) * (TS + 1);
            for (int s = 0; s < TS; ++s)
              acc = fmaf(mrow[s], xs[s * PT + tx * PPT + j], acc);
            dia[i][j] = acc;
          }
        __syncthreads();  // Bt / xs / Ms are restaged next
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gt = t0 + ty * 4 + i, pos = c0 + gt;
        if (gt >= L || pos >= S) continue;
        T* yrow = y + (((long long)bi * S + pos) * nh + h) * hp + p0;
#pragma unroll
        for (int j = 0; j < PPT; ++j)
          yrow[tx * PPT + j] = from_float<T>(dia[i][j] + off[i][j]);
      }
      __syncthreads();  // Ct is restaged next
    }

    // ---- state update: sum the chunk's terms, then add the decayed h ----
    float upd[HMAX];
#pragma unroll
    for (int k = 0; k < HMAX; ++k) upd[k] = 0.f;
    for (int si = 0; si < nsub; ++si) {
      const int s0 = si * TS;
      stage_nmajor(Bm, Bt, bi, h, c0, s0, L, S, nh, N);
      for (int i = tid; i < TS * PT; i += THREADS) {
        const int r = i / PT, p = i % PT;
        const int t = s0 + r, pos = c0 + t;
        float v = 0.f;
        if (t < L && pos < S)
          v = to_float(x[(((long long)bi * S + pos) * nh + h) * hp + p0 + p]);
        xs[i] = v;
      }
      for (int r = tid; r < TS; r += THREADS) {
        const int t = s0 + r;
        s_w[r] = t < L ? s_dt[t] * expf(a_last - s_acs[t]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < HMAX; ++k) {
        const int idx = tid + k * THREADS;
        if (idx >= PT * N) break;
        const int p = idx / N, n = idx % N;
        float acc = upd[k];
        for (int s = 0; s < TS; ++s)
          acc = fmaf(xs[s * PT + p] * s_w[s], Bt[n * (TS + 1) + s], acc);
        upd[k] = acc;
      }
      __syncthreads();
    }
    const float dec = expf(a_last);
#pragma unroll
    for (int k = 0; k < HMAX; ++k) {
      const int idx = tid + k * THREADS;
      if (idx >= PT * N) break;
      const int p = idx / N, n = idx % N;
      hs[p * (N + 1) + n] = hs[p * (N + 1) + n] * dec + upd[k];
    }
  }
  __syncthreads();
  for (int i = tid; i < PT * N; i += THREADS) {
    const int p = i / N, n = i % N;
    hout[(((long long)bh) * hp + p0 + p) * N + n] = hs[p * (N + 1) + n];
  }
}

template <typename T, int PPT>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, void* y, void* h, int b, int S, int nh, int hp,
           int N, int L, cudaStream_t s) {
  constexpr int PT = 16 * PPT;
  if ((long long)PT * N > (long long)THREADS * HMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_floats<PT>(L, N);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = ssd_kernel<T, PPT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((unsigned)(b * nh), (unsigned)(hp / PT));
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), static_cast<float*>(h),
      S, nh, hp, N, L);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_pt(const void* x, const void* dt, const void* A, const void* B,
              const void* C, void* y, void* h, int b, int S, int nh, int hp,
              int N, int L, cudaStream_t s) {
  if (hp % 32 == 0)
    return launch<T, 2>(x, dt, A, B, C, y, h, b, S, nh, hp, N, L, s);
  if (hp % 16 == 0)
    return launch<T, 1>(x, dt, A, B, C, y, h, b, S, nh, hp, N, L, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int rt_ssd_scan(const void* x, const void* dt, const void* A,
                           const void* B, const void* C, void* y, void* h,
                           int b, int S, int nh, int hp, int N, int L,
                           int dtype, void* stream) {
  if (b <= 0 || S <= 0 || nh <= 0) return 0;
  if (L <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_BF16)
    return launch_pt<__nv_bfloat16>(x, dt, A, B, C, y, h, b, S, nh, hp, N, L,
                                    s);
  if (dtype == RT_F32)
    return launch_pt<float>(x, dt, A, B, C, y, h, b, S, nh, hp, N, L, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
