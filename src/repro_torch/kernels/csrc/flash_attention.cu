// Flash-attention forward (prefill) for Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_fwd
// (body _fwd_kernel): causal / sliding-window GQA attention with an
// online softmax in f32, tiles skipped when wholly above the diagonal or
// outside the window, key columns >= T masked, output acc / max(l, 1e-30).
//
// Layouts are the reference's: q (B, S, Hq, D), k/v (B, T, Hkv, D),
// out (B, S, Hq, D), all contiguous. kv head = q head / G; K and V are
// never replicated. Positions of q and k are both numbered from 0.
//
// Bound on this card: operations. At the prefill shapes of the main
// path (S up to 1024, D = 64) the causal product needs ~S/2 * 4D flops
// per query row against 4D bytes of q/out, well above the ridge. This
// first kernel computes in f32 on the CUDA cores (no wgmma yet), so it
// runs far from the bf16 tensor-core bound; what the design does is
// keep every intermediate out of device memory: one block per
// (b * Hq + h, 64-row q tile), a loop over 32-key tiles staged in
// shared memory, and the running (m, l, acc) in f32 shared memory and
// registers. The score tile is register-blocked (8 rows per thread) and
// K is stored with a padded row stride, so the shared-memory reads are
// free of bank conflicts.
#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // keys per tile (one warp lane per key)
constexpr int THREADS = 256;  // 8 warps

template <int D>
constexpr int smem_floats() {
  // sQ (BQ x D), sK (BK x (D+1)), sV (BK x D), sP (BQ x (BK+1)),
  // sM, sL, sA (BQ each)
  return BQ * D + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int Tn,
                 int Hq, int Hkv, float sm_scale, int causal, int window) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * D;
  float* sV = sK + BK * (D + 1);
  float* sP = sV + BK * D;
  float* sM = sP + BQ * (BK + 1);
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q_start = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int i = e / D, c = e % D, s = q_start + i;
    sQ[e] = s < S ? to_float(q[(((long long)b * S + s) * Hq + h) * D + c])
                  : 0.f;
  }
  for (int i = tid; i < BQ; i += THREADS) {
    sM[i] = RT_NEG_INF;
    sL[i] = 0.f;
  }

  // acc ownership: column dcol of rows row0 + r * RPP
  constexpr int RPP = THREADS / D;
  constexpr int NACC = BQ / RPP;
  const int dcol = tid % D, row0 = tid / D;
  float acc[NACC];
#pragma unroll
  for (int r = 0; r < NACC; ++r) acc[r] = 0.f;
  __syncthreads();

  const int n_kt = (Tn + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_start = kt * BK;
    if (causal && k_start > q_start + BQ - 1) break;  // above the diagonal
    if (window && !(k_start + BK > q_start - window + 1)) continue;

    for (int e = tid; e < BK * D; e += THREADS) {
      const int j = e / D, c = e % D, t = k_start + j;
      float kv = 0.f, vv = 0.f;
      if (t < Tn) {
        const long long off = (((long long)b * Tn + t) * Hkv + hk) * D + c;
        kv = to_float(k[off]);
        vv = to_float(v[off]);
      }
      sK[j * (D + 1) + c] = kv;
      sV[j * D + c] = vv;
    }
    __syncthreads();

    // scores: lane = key column, rows warp + 8n
    {
      constexpr int RB = BQ / (THREADS / 32);  // 8 rows per thread
      float s[RB];
#pragma unroll
      for (int n = 0; n < RB; ++n) s[n] = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        const float kc = sK[lane * (D + 1) + c];
#pragma unroll
        for (int n = 0; n < RB; ++n)
          s[n] += sQ[(warp + n * (THREADS / 32)) * D + c] * kc;
      }
      const int kp = k_start + lane;
#pragma unroll
      for (int n = 0; n < RB; ++n) {
        const int i = warp + n * (THREADS / 32);
        const int qp = q_start + i;
        bool ok = kp < Tn;
        if (causal) ok = ok && kp <= qp;
        if (window) ok = ok && kp > qp - window;
        sP[i * (BK + 1) + lane] = ok ? s[n] * sm_scale : RT_NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: one warp per row, one lane per key
    for (int i = warp; i < BQ; i += THREADS / 32) {
      const float s = sP[i * (BK + 1) + lane];
      const float m_prev = sM[i];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = expf(s - m_new);
      const float psum = warp_sum(p);
      sP[i * (BK + 1) + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sL[i] = sL[i] * alpha + psum;
        sM[i] = m_new;
        sA[i] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < NACC; ++r) acc[r] *= sA[row0 + r * RPP];
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float vj = sV[j * D + dcol];
#pragma unroll
      for (int r = 0; r < NACC; ++r)
        acc[r] += sP[(row0 + r * RPP) * (BK + 1) + j] * vj;
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < NACC; ++r) {
    const int i = row0 + r * RPP, s = q_start + i;
    if (s < S)
      o[(((long long)b * S + s) * Hq + h) * D + dcol] =
          from_float<T>(acc[r] / fmaxf(sL[i], 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tn, int Hq, int Hkv, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kern = flash_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((unsigned)(B * Hq), (unsigned)((S + BQ - 1) / BQ));
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tn, Hq, Hkv,
      1.0f / sqrtf((float)D), causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int S, int Tn, int Hq, int Hkv, int D, int causal, int window,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, Tn, Hq, Hkv, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, Tn, Hq, Hkv, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Tn, Hq, Hkv, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Tn, Hq, Hkv, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int S, int Tn, int Hq,
                                  int Hkv, int D, int causal, int window,
                                  int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_BF16)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, S, Tn, Hq, Hkv, D, causal,
                                   window, s);
  if (dtype == RT_F32)
    return launch_d<float>(q, k, v, o, B, S, Tn, Hq, Hkv, D, causal, window,
                           s);
  return static_cast<int>(cudaErrorInvalidValue);
}
