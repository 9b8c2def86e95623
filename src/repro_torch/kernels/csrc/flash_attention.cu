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
// path (S up to 1024, D 64, 80, 128 or 160) the causal product needs
// ~S/2 * 4D flops per query row against 4D bytes of q/out, well above
// the ridge.
//
// At D 80 (zamba2-2.7b) a third body runs in both dtypes, equal to the
// plain version bit for bit (flash_chunked.cuh says why). At D 16, 32,
// 64, 128 and 160 (stablelm-12b), two bodies, chosen before the launch
// by dtype and alignment:
//
// * bf16 inputs whose pointers are 16-byte aligned (every served prefill)
//   run flash_fwd_mma, on the tensor cores with warp-level
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (not wgmma).
//   Each warp owns 16 query rows and a block 64 (4 warps) at every D:
//   at D 64, blocks of 128 rows (8 warps) took 0.0853-0.0863 ms against
//   0.0837 (python -m repro_torch.bench.flash_attention, B 2, S 1024,
//   36 heads, H100 SXM at 700 W). The Q tile arrives once by
//   16-byte cp.async and stays in registers as A fragments (ldmatrix)
//   up to D 128; at D 160 (10 k-steps of 16: 20 output fragments of 4
//   f32 a lane) the fragments would not fit beside the accumulators,
//   so each K tile reloads them from shared memory with ldmatrix.
//   K and V come in 64-key tiles through a two-stage cp.async ring in
//   dynamic shared memory, the next tile loading while the current one
//   is multiplied; rows past T are zero-filled by the copy itself. Rows
//   are padded by 16 bytes, so ldmatrix (and ldmatrix.trans for V) read
//   without bank conflicts. Scores stay in the mma accumulators; the
//   masks apply only on tiles that cross the diagonal, the window's edge
//   or T, and a warp skips tiles wholly above its own diagonal. Row max
//   and sum take the four lanes that share a row. P goes into P.V from
//   registers, as two bf16 terms hi = bf16(p) and lo = bf16(p - hi)
//   multiplied into one f32 accumulator: P rounded once to bf16 would
//   break the bf16 bar against the plain version (f32 softmax, output
//   rounded once), the two terms keep it within one ulp
//   (tests/test_torch_kernel_numerics.py shows both on the CPU).
//   The output is rounded once to bf16 and leaves through shared memory
//   with 16-byte stores. Query tiles launch longest first (reverse order
//   along S), so causal work balances over the SMs.
// * f32 inputs (the tuner's cases) and unaligned bf16 views run
//   flash_fwd_kernel on the f32 CUDA cores: one block per (b * Hq + h,
//   64-row q tile), a loop over 32-key tiles staged in shared memory, the
//   running (m, l, acc) in f32 shared memory and registers. An f32 Q.K^T
//   on bf16 tensor cores would need at least three bf16 pieces of each
//   operand to stay within 1e-5 of the f32 result, which no served model
//   needs.
#include "common.cuh"
#include "flash_chunked.cuh"
#include "mma.cuh"
#include "plan.cuh"

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

  // acc ownership: column dcol of rows row0 + r * RPP, by the first
  // RPP * D threads (all of them unless D does not divide THREADS: at
  // D 160 threads 160..255 own none)
  constexpr int RPP = THREADS / D;
  constexpr int NACC = BQ / RPP;
  const int dcol = tid % D, row0 = tid / D;
  const bool owner = RPP * D == THREADS || tid < RPP * D;
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

    if (owner) {
#pragma unroll
      for (int r = 0; r < NACC; ++r) acc[r] *= sA[row0 + r * RPP];
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float vj = sV[j * D + dcol];
#pragma unroll
        for (int r = 0; r < NACC; ++r)
          acc[r] += sP[(row0 + r * RPP) * (BK + 1) + j] * vj;
      }
    }
    __syncthreads();
  }

  if (!owner) return;
#pragma unroll
  for (int r = 0; r < NACC; ++r) {
    const int i = row0 + r * RPP, s = q_start + i;
    if (s < S)
      o[(((long long)b * S + s) * Hq + h) * D + dcol] =
          from_float<T>(acc[r] / fmaxf(sL[i], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bf16 body on the tensor cores
// ---------------------------------------------------------------------------
constexpr int MMA_BK = 64;                 // keys per K/V tile
constexpr int MMA_BQ = 64;                 // query rows per block
constexpr int MMA_THREADS = 2 * MMA_BQ;    // 4 warps, 16 query rows each

template <int D>
struct MmaCfg {
  static constexpr int LD = D + 8;         // padded row, bf16 elements
  static constexpr int CH = D / 8;         // 16-byte chunks per row
  static constexpr bool QREG = D <= 128;   // Q fragments kept in registers
  // sQ (MMA_BQ rows), then K and V, two stages each (MMA_BK rows)
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (size_t)LD * (MMA_BQ + 4 * MMA_BK);
};

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int S, int Tn, int Hq, int Hkv,
              float sm_scale, int causal, int window) {
  using C = MmaCfg<D>;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + MMA_BQ * C::LD;
  bf16* sV = sK + 2 * MMA_BK * C::LD;

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q_start = (gridDim.y - 1 - blockIdx.y) * MMA_BQ;  // longest first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long q_stride = (long long)Hq * D, kv_stride = (long long)Hkv * D;
  const bf16* qb = q + ((long long)b * S * Hq + h) * D;
  const bf16* kb = k + ((long long)b * Tn * Hkv + hk) * D;
  const bf16* vb = v + ((long long)b * Tn * Hkv + hk) * D;

  // the K/V tiles this block needs: none wholly above its last row's
  // diagonal, none wholly before its first row's window
  const int q_last = min(q_start + MMA_BQ, S) - 1;
  const int n_kt = (Tn + MMA_BK - 1) / MMA_BK;
  const int kt_end = causal ? min(n_kt, q_last / MMA_BK + 1) : n_kt;
  int kt_begin = 0;
  if (window) {
    const int first = q_start - window + 1;
    if (first > 0) kt_begin = first / MMA_BK;
  }

  for (int c = tid; c < MMA_BQ * C::CH; c += MMA_THREADS) {
    const int r = c / C::CH, cc = c % C::CH, s = q_start + r;
    const bool ok = s < S;
    cp_async16(smem_addr(sQ + r * C::LD + cc * 8),
               ok ? qb + s * q_stride + cc * 8 : qb, ok);
  }
  auto load_kv = [&](int kt, int stage) {
    bf16* dk = sK + stage * MMA_BK * C::LD;
    bf16* dv = sV + stage * MMA_BK * C::LD;
    for (int c = tid; c < MMA_BK * C::CH; c += MMA_THREADS) {
      const int r = c / C::CH, cc = c % C::CH, tk = kt * MMA_BK + r;
      const bool ok = tk < Tn;
      const long long off = ok ? tk * kv_stride + cc * 8 : 0;
      cp_async16(smem_addr(dk + r * C::LD + cc * 8), kb + off, ok);
      cp_async16(smem_addr(dv + r * C::LD + cc * 8), vb + off, ok);
    }
  };
  if (kt_begin < kt_end) load_kv(kt_begin, 0);
  cp_async_commit();

  const int w_row0 = q_start + warp * 16;  // this warp's first query row
  const bool w_live = w_row0 < S;
  uint32_t qf[C::QREG ? D / 16 : 1][4];
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_r[2] = {RT_NEG_INF, RT_NEG_INF};  // rows g and g + 8
  float l_r[2] = {0.f, 0.f};                // this lane's part of the sum

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      load_kv(kt + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (C::QREG && kt == kt_begin) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        ldmatrix_x4(qf[kd], smem_addr(sQ + (warp * 16 + (lane & 15)) * C::LD +
                                      kd * 16 + (lane >> 4) * 8));
    }
    const int k_start = kt * MMA_BK;
    if (w_live && !(causal && k_start > w_row0 + 15)) {
      const bf16* tK = sK + stage * MMA_BK * C::LD;
      const bf16* tV = sV + stage * MMA_BK * C::LD;
      // S = Q K^T: 8 n-tiles of 8 keys
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        uint32_t (&qa)[4] = qf[C::QREG ? kd : 0];
        if constexpr (!C::QREG)
          ldmatrix_x4(qa, smem_addr(sQ + (warp * 16 + (lane & 15)) * C::LD +
                                    kd * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bk[4];
          ldmatrix_x4(bk, smem_addr(tK + (np * 16 + (lane & 7) +
                                          ((lane >> 4) << 3)) * C::LD +
                                    kd * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(s[2 * np], qa, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
        }
      }
      const bool masked = (causal && k_start + MMA_BK - 1 > w_row0) ||
                          (window && k_start <= w_row0 + 15 - window) ||
                          k_start + MMA_BK > Tn;
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * sm_scale;
          if (masked) {
            const int kp = k_start + nt * 8 + 2 * t + (e & 1);
            const int qp = w_row0 + g + (e >> 1) * 8;
            bool ok = kp < Tn;
            if (causal) ok = ok && kp <= qp;
            if (window) ok = ok && kp > qp - window;
            if (!ok) x = RT_NEG_INF;
          }
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = expf(m_r[i] - mx[i]);
        m_r[i] = mx[i];
      }
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[nt][e] - m_r[e >> 1]);
          s[nt][e] = p;
          psum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + psum[i];
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][0] *= alpha[0];
        acc[dt][1] *= alpha[0];
        acc[dt][2] *= alpha[1];
        acc[dt][3] *= alpha[1];
      }
      // O += P V: P from the score accumulators, as hi + lo bf16 terms
#pragma unroll
      for (int kk = 0; kk < MMA_BK / 16; ++kk) {
        uint32_t ph[4], pl[4];
        ph[0] = split_bf16(s[2 * kk][0], s[2 * kk][1]);
        ph[1] = split_bf16(s[2 * kk][2], s[2 * kk][3]);
        ph[2] = split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        ph[3] = split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        pl[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pl[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pl[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pl[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, smem_addr(tV + (kk * 16 + (lane & 7) +
                                                ((lane >> 3) & 1) * 8) * C::LD +
                                          dp * 16 + (lane >> 4) * 8));
          mma_bf16(acc[2 * dp], ph, bv[0], bv[1]);
          mma_bf16(acc[2 * dp], pl, bv[0], bv[1]);
          mma_bf16(acc[2 * dp + 1], ph, bv[2], bv[3]);
          mma_bf16(acc[2 * dp + 1], pl, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: acc / max(l, 1e-30), rounded once, staged in this warp's
  // rows of sQ, then 16-byte stores
  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    den[i] = fmaxf(l, 1e-30f);
  }
  bf16* sO = sQ + warp * 16 * C::LD;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(sO + g * C::LD + col) =
        pack_bf16(acc[dt][0] / den[0], acc[dt][1] / den[0]);
    *reinterpret_cast<uint32_t*>(sO + (g + 8) * C::LD + col) =
        pack_bf16(acc[dt][2] / den[1], acc[dt][3] / den[1]);
  }
  __syncwarp();
  bf16* ob = o + ((long long)b * S * Hq + h) * D;
  for (int c = lane; c < 16 * C::CH; c += 32) {
    const int r = c / C::CH, cc = c % C::CH, s = w_row0 + r;
    if (s < S)
      *reinterpret_cast<uint4*>(ob + s * q_stride + cc * 8) =
          *reinterpret_cast<const uint4*>(sO + r * C::LD + cc * 8);
  }
}

// ---------------------------------------------------------------------------
// Launch plans and the body choice
// ---------------------------------------------------------------------------
// CUDA-core body: one block per (b * Hq + h, BQ query rows).
template <typename T, int D>
RtLaunch plan_simt(int B, int S, int Hq) {
  return rt_plan((const void*)flash_fwd_kernel<T, D>,
                 dim3((unsigned)(B * Hq), (unsigned)((S + BQ - 1) / BQ)),
                 dim3(THREADS), sizeof(float) * smem_floats<D>(),
                 "flash_fwd_kernel<%s,%d>", rt_tname<T>(), D);
}

// Tensor-core body: one block per (b * Hq + h, MMA_BQ query rows), the
// query tiles in reverse order.
template <int D>
RtLaunch plan_mma(int B, int S, int Hq) {
  return rt_plan((const void*)flash_fwd_mma<D>,
                 dim3((unsigned)(B * Hq),
                      (unsigned)((S + MMA_BQ - 1) / MMA_BQ)),
                 dim3(MMA_THREADS), MmaCfg<D>::SMEM, "flash_fwd_mma<%d>", D);
}

// The tensor-core body for aligned bf16, else the CUDA-core body.
template <typename T, int D, class Op>
int body(int B, int S, int Hq, bool aligned, const Op& op) {
  if constexpr (sizeof(T) == 2) {
    if (aligned) return op(plan_mma<D>(B, S, Hq), &flash_fwd_mma<D>);
  }
  return op(plan_simt<T, D>(B, S, Hq), &flash_fwd_kernel<T, D>);
}

// The body a call runs, handed to op with its plan (Run launches it,
// RecordPlan records it). D 80 runs the plain version's chunked order at
// `chunk` capped at Tn; aligned: q, k, v and out are 16-byte aligned.
template <typename T, class Op>
int dispatch(int B, int S, int Tn, int Hq, int D, int chunk, bool aligned,
             const Op& op) {
  switch (D) {
    case 80: {
      if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
      const int c = chunk > Tn ? Tn : chunk;
      return op(chunked::plan<T, 80>(B, S, Hq, c),
                &chunked::flash_fwd_chunked<T, 80>, c);
    }
    case 16: return body<T, 16>(B, S, Hq, aligned, op);
    case 32: return body<T, 32>(B, S, Hq, aligned, op);
    case 64: return body<T, 64>(B, S, Hq, aligned, op);
    case 128: return body<T, 128>(B, S, Hq, aligned, op);
    case 160: return body<T, 160>(B, S, Hq, aligned, op);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
using Kernel = void (*)(const T*, const T*, const T*, T*, int, int, int, int,
                        float, int, int);
template <typename T>
using ChunkedKernel = void (*)(const T*, const T*, const T*, T*, int, int,
                               int, int, float, int, int, int, int, int);

template <typename T>
struct Run {
  const void *q, *k, *v;
  void* o;
  int B, S, Tn, Hq, Hkv, D, causal, window;
  cudaStream_t stream;

  int operator()(const RtLaunch& p, Kernel<T> kern) const {
    const int e = rt_smem_optin(p);
    if (e) return e;
    kern<<<rt_grid(p), rt_block(p), p.smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), S, Tn, Hq, Hkv,
        1.0f / sqrtf((float)D), causal, window);
    return static_cast<int>(cudaGetLastError());
  }
  int operator()(const RtLaunch& p, ChunkedKernel<T> kern, int chunk) const {
    const int e = rt_smem_optin(p);
    if (e) return e;
    const long long R = (long long)B * Hq * S;     // rows of the plain p
    const int last = Tn % chunk ? Tn % chunk : chunk;
    kern<<<rt_grid(p), rt_block(p), p.smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), S, Tn, Hq, Hkv,
        (float)(1.0 / sqrt((double)D)), causal, window, chunk,
        chunked::aten_lanes(R, chunk), chunked::aten_lanes(R, last));
    return static_cast<int>(cudaGetLastError());
  }
};

struct RecordPlan {
  RtPlanSink* sink;
  template <typename K, typename... Rest>
  int operator()(const RtLaunch& p, K, Rest...) const {
    sink->add(p);
    return 0;
  }
};

}  // namespace

extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, int B, int S, int Tn, int Hq,
                                  int Hkv, int D, int causal, int window,
                                  int chunk, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool al = rt_aligned16(q) && rt_aligned16(k) && rt_aligned16(v) &&
                  rt_aligned16(o);
  if (dtype == RT_BF16)
    return dispatch<__nv_bfloat16>(
        B, S, Tn, Hq, D, chunk, al,
        Run<__nv_bfloat16>{q, k, v, o, B, S, Tn, Hq, Hkv, D, causal, window,
                           s});
  if (dtype == RT_F32)
    return dispatch<float>(
        B, S, Tn, Hq, D, chunk, al,
        Run<float>{q, k, v, o, B, S, Tn, Hq, Hkv, D, causal, window, s});
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launches rt_flash_attention makes (aligned: q, k, v and out 16-byte
// aligned, as fresh allocations are): the count, at most cap of them
// written to out; a negative CUDA error code where it would refuse.
extern "C" int rt_flash_attention_plan(int B, int S, int Tn, int Hq, int D,
                                       int chunk, int dtype, int aligned,
                                       RtLaunch* out, int cap) {
  if (B <= 0 || S <= 0) return 0;
  RtPlanSink sink{out, cap, 0};
  const RecordPlan op{&sink};
  int e;
  if (dtype == RT_BF16)
    e = dispatch<__nv_bfloat16>(B, S, Tn, Hq, D, chunk, aligned != 0, op);
  else if (dtype == RT_F32)
    e = dispatch<float>(B, S, Tn, Hq, D, chunk, aligned != 0, op);
  else
    e = static_cast<int>(cudaErrorInvalidValue);
  return e ? -e : sink.n;
}
