// Fused RMSNorm for Hopper.
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm_pallas (body
// _rmsnorm_kernel): f32 mean of squares over the last axis, then
// x * rsqrt(mean + eps) * scale, cast to x's dtype on write.
//
// Bound on this card: bytes. It reads each row once and writes it once
// (2 * rows * d * sizeof(T)) for ~4 flops per element, far below the
// H100's ~295 flops/byte ridge. The scale is always float32 (the model
// keeps norm scales in f32, as the reference multiplies by the f32 master
// scale).
//
// Two bodies, chosen before the launch:
// * rmsnorm_vec (d a multiple of 4 and at least 128, at most 32 vectors
//   of 4 a thread: every served row) keeps a row in registers as loaded:
//   each of its threads issues all of its loads of 4 elements (8 bytes of
//   bf16 or 16 of f32; an unaligned slice loads them one by one) before it
//   uses any, reduces, and writes the row back from registers, so the row
//   crosses HBM once each way. The reduction is the one PyTorch's CUDA
//   reduction (ATen's Reduce.cuh) runs for the plain version's
//   x.float().square().mean(-1): TPR threads a row, the power of 2 at or
//   below the row's vectors, capped at 512 / min(16, rows rounded down to
//   a power of 2); thread x sums the squares
//   (rounded apart) of vectors x, x + TPR, ... into 4 accumulators, one a
//   vector lane, then (((a0 + a1) + a2) + a3); above 32 threads a
//   shared-memory tree (offsets TPR / 2 .. 32), then a warp shuffle-down
//   tree (offsets 16 .. 1, as the card's PyTorch walks them); the mean is
//   the sum times float(rows) / float(rows * d); then rsqrtf(mean + eps),
//   x * r, * scale, each rounded apart. So a row equals rmsnorm_plain's bit for
//   bit on the card (tests/test_torch_cuda.py): a norm that sums in
//   another order moved ~1e-5 of its bf16 outputs one ulp, which
//   mamba2-1.3b's 48 full-depth layers carried to a logit difference of
//   0.25, the bar (PERF.md §6). 256 / TPR rows share a block (one row
//   a block of 512 at TPR 512).
//   Two consequences. (1) A row's bits depend on how many rows share
//   the call, as the plain version's do: TPR and the mean's factor
//   change with the row count, so a row normed alone may differ by an
//   ulp from the same row inside a prefill. (2) The order is a private
//   heuristic of PyTorch's, copied from the version the card runs
//   (kernels/rmsnorm.py REDUCE_ORDER_TORCH); another version may change
//   it, and then this kernel still meets the one-ulp bar but no longer
//   equals rmsnorm_plain bit for bit.
// * rmsnorm_wide (the same rows past 32 vectors a thread: zamba2-2.7b's
//   gated norm, d 5120 at 16 rows or more, 40 vectors a thread) sums the
//   same squares in the same order, each vector loaded where it is
//   added, and reads the row a second time for the write (from L1/L2),
//   so it too equals rmsnorm_plain bit for bit.
// * rmsnorm_scalar (every other row: d < 128 or not a multiple of 4,
//   rows PyTorch splits across blocks): one block a row, strided scalar
//   loads, the second read of the row for the write served by L1/L2.
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int MAX_VPL = 32;     // vectors of 4 a thread
constexpr int MAX_TPR = 512;    // threads a row (PyTorch's block cap)

// Four elements of a row as loaded (8 bytes of bf16, 16 of f32), widened
// to f32 where used.
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using raw = float4;
  __device__ static raw load(const float* p, bool vec) {
    if (vec) return *reinterpret_cast<const float4*>(p);
    return make_float4(p[0], p[1], p[2], p[3]);
  }
  __device__ static void widen(const raw& v, float (&f)[4]) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static void store(float* p, bool vec, const float (&f)[4]) {
    if (vec) {
      *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = f[i];
    }
  }
};
template <>
struct Vec4<__nv_bfloat16> {
  using raw = uint2;
  __device__ static raw load(const __nv_bfloat16* p, bool vec) {
    if (vec) return *reinterpret_cast<const uint2*>(p);
    const uint16_t* q = reinterpret_cast<const uint16_t*>(p);
    return make_uint2(q[0] | (uint32_t)q[1] << 16, q[2] | (uint32_t)q[3] << 16);
  }
  __device__ static void widen(const raw& v, float (&f)[4]) {
    const float2 a = unpack_bf16(v.x), b = unpack_bf16(v.y);
    f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  }
  __device__ static void store(__nv_bfloat16* p, bool vec,
                               const float (&f)[4]) {
    if (vec) {
      *reinterpret_cast<uint2*>(p) =
          make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = from_float<__nv_bfloat16>(f[i]);
    }
  }
};

// Adds the squares of a vector's 4 elements to the 4 accumulators, each
// product and sum rounded apart.
__device__ __forceinline__ void add_squares(float (&acc)[4],
                                            const float (&f)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(f[i], f[i]));
}

// The row's sum of squares from each of its TPR threads' 4 accumulators,
// in ATen's order (see the top of the file); every thread of the block
// must call it. Thread tx of row rw; part has a float a thread.
template <int TPR>
__device__ __forceinline__ float row_sum(const float (&acc)[4], float* part,
                                         float* total, int tx, int rw) {
  float s = __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  if constexpr (TPR > 32) {
    part[threadIdx.x] = s;
#pragma unroll
    for (int off = TPR / 2; off >= 32; off >>= 1) {
      __syncthreads();
      if (tx < off) {
        s = __fadd_rn(s, part[threadIdx.x + off]);
        part[threadIdx.x] = s;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  if (tx == 0) total[rw] = s;
  __syncthreads();
  return total[rw];
}

// Vector j of a row, normed with r and the scale, rounded on write.
template <typename T>
__device__ __forceinline__ void write_vec(T* orow, const float* scale, int j,
                                          const typename Vec4<T>::raw& v,
                                          float r, bool vec) {
  const float4 sc = *reinterpret_cast<const float4*>(scale + 4 * j);
  const float w[4] = {sc.x, sc.y, sc.z, sc.w};
  float f[4];
  Vec4<T>::widen(v, f);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __fmul_rn(__fmul_rn(f[i], r), w[i]);
  Vec4<T>::store(orow + 4 * j, vec, f);
}

template <typename T, int TPR, int VPL>
__global__ void __launch_bounds__(TPR > 256 ? TPR : 256)
rmsnorm_vec(const T* __restrict__ x, const float* __restrict__ scale,
            T* __restrict__ out, long long rows, int d, float factor,
            float eps, bool vec) {
  using V = Vec4<T>;
  constexpr int THREADS = TPR > 256 ? TPR : 256;
  constexpr int RPB = THREADS / TPR;              // rows a block
  __shared__ float part[THREADS];
  __shared__ float total[RPB];
  const int tx = threadIdx.x % TPR, rw = threadIdx.x / TPR;
  const long long row = (long long)blockIdx.x * RPB + rw;
  const bool live = row < rows;
  const int nvec = d / 4;
  const T* xr = x + row * d;

  typename V::raw v[VPL];
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
#pragma unroll
    for (int k = 0; k < VPL; ++k)
      if (tx + k * TPR < nvec) v[k] = V::load(xr + 4 * (tx + k * TPR), vec);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (tx + k * TPR < nvec) {
        float f[4];
        V::widen(v[k], f);
        add_squares(acc, f);
      }
    }
  }
  const float s = row_sum<TPR>(acc, part, total, tx, rw);
  if (!live) return;

  const float r = rsqrtf(__fadd_rn(__fmul_rn(s, factor), eps));
  T* orow = out + row * d;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int j = tx + k * TPR;
    if (j < nvec) write_vec(orow, scale, j, v[k], r, vec);
  }
}

// rmsnorm_vec's sums for a row of more than MAX_VPL vectors a thread:
// each vector loaded where it is added, the row read again to write.
template <typename T, int TPR>
__global__ void __launch_bounds__(TPR > 256 ? TPR : 256)
rmsnorm_wide(const T* __restrict__ x, const float* __restrict__ scale,
             T* __restrict__ out, long long rows, int d, float factor,
             float eps, bool vec) {
  using V = Vec4<T>;
  constexpr int THREADS = TPR > 256 ? TPR : 256;
  constexpr int RPB = THREADS / TPR;              // rows a block
  __shared__ float part[THREADS];
  __shared__ float total[RPB];
  const int tx = threadIdx.x % TPR, rw = threadIdx.x / TPR;
  const long long row = (long long)blockIdx.x * RPB + rw;
  const bool live = row < rows;
  const int nvec = d / 4;
  const T* xr = x + row * d;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    for (int j = tx; j < nvec; j += TPR) {
      float f[4];
      V::widen(V::load(xr + 4 * j, vec), f);
      add_squares(acc, f);
    }
  }
  const float s = row_sum<TPR>(acc, part, total, tx, rw);
  if (!live) return;

  const float r = rsqrtf(__fadd_rn(__fmul_rn(s, factor), eps));
  T* orow = out + row * d;
  for (int j = tx; j < nvec; j += TPR)
    write_vec(orow, scale, j, V::load(xr + 4 * j, vec), r, vec);
}

template <typename T>
__global__ void rmsnorm_scalar(const T* __restrict__ x,
                               const float* __restrict__ scale,
                               T* __restrict__ out, int d, float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_float(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);

  __shared__ float part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) part[0] = v;
  }
  __syncthreads();

  const float r = rsqrtf(part[0] / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    orow[i] = from_float<T>(to_float(xr[i]) * r * scale[i]);
}

template <typename T, int TPR, int VPL>
int launch_vec(const void* x, const void* scale, void* out, long long rows,
               int d, float factor, float eps, bool vec, cudaStream_t s) {
  constexpr int THREADS = TPR > 256 ? TPR : 256;
  constexpr int RPB = THREADS / TPR;
  rmsnorm_vec<T, TPR, VPL><<<(unsigned)((rows + RPB - 1) / RPB), THREADS, 0,
                             s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(out), rows, d, factor, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

// VPL rounded up to a power of 2 (the extra vectors idle); past MAX_VPL
// the row-rereading body.
template <typename T, int TPR>
int launch_vpl(int vpl, const void* x, const void* scale, void* out,
               long long rows, int d, float factor, float eps, bool vec,
               cudaStream_t s) {
  if (vpl > MAX_VPL) {
    constexpr int THREADS = TPR > 256 ? TPR : 256;
    constexpr int RPB = THREADS / TPR;
    rmsnorm_wide<T, TPR><<<(unsigned)((rows + RPB - 1) / RPB), THREADS, 0,
                           s>>>(
        static_cast<const T*>(x), static_cast<const float*>(scale),
        static_cast<T*>(out), rows, d, factor, eps, vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (vpl <= 1) return launch_vec<T, TPR, 1>(x, scale, out, rows, d, factor, eps, vec, s);
  if (vpl <= 2) return launch_vec<T, TPR, 2>(x, scale, out, rows, d, factor, eps, vec, s);
  if (vpl <= 4) return launch_vec<T, TPR, 4>(x, scale, out, rows, d, factor, eps, vec, s);
  if (vpl <= 8) return launch_vec<T, TPR, 8>(x, scale, out, rows, d, factor, eps, vec, s);
  if (vpl <= 16) return launch_vec<T, TPR, 16>(x, scale, out, rows, d, factor, eps, vec, s);
  return launch_vec<T, TPR, 32>(x, scale, out, rows, d, factor, eps, vec, s);
}

long long last_pow2(long long n) {
  long long p = 1;
  while (p * 2 <= n) p *= 2;
  return p;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch(const void* x, const void* scale, void* out, long long rows, int d,
           float eps, cudaStream_t s) {
  // PyTorch's block for the plain version's reduction (Reduce.cuh
  // set_block_dimension on d / 4 vectors by rows outputs): height
  // min(last_pow2(rows), 16), width min(last_pow2(d / 4) capped at 512,
  // 512 / height); a row stays in one block while each thread sums fewer
  // than min(16 height, 256) values.
  const long long nvec = d / 4;
  const int height = (int)(rows < 16 ? last_pow2(rows) : 16);
  const long long width0 = nvec < MAX_TPR ? last_pow2(nvec > 0 ? nvec : 1)
                                          : MAX_TPR;
  const int tpr = (int)(width0 < MAX_TPR / height ? width0 : MAX_TPR / height);
  const int vpl = (int)((nvec + tpr - 1) / tpr);
  const int split_at = 16 * height < 256 ? 16 * height : 256;
  if (d % 4 == 0 && d >= 128 && tpr >= 32 &&
      (d + tpr - 1) / tpr < split_at && aligned(scale, 16)) {
    const bool vec =
        aligned(x, 4 * sizeof(T)) && aligned(out, 4 * sizeof(T));
    const float factor = (float)rows / (float)(rows * d);
    switch (tpr) {
      case 32: return launch_vpl<T, 32>(vpl, x, scale, out, rows, d, factor, eps, vec, s);
      case 64: return launch_vpl<T, 64>(vpl, x, scale, out, rows, d, factor, eps, vec, s);
      case 128: return launch_vpl<T, 128>(vpl, x, scale, out, rows, d, factor, eps, vec, s);
      case 256: return launch_vpl<T, 256>(vpl, x, scale, out, rows, d, factor, eps, vec, s);
      default: return launch_vpl<T, 512>(vpl, x, scale, out, rows, d, factor, eps, vec, s);
    }
  }
  const int threads = d >= 2048 ? 256 : (d >= 512 ? 128 : 32);
  rmsnorm_scalar<T><<<(unsigned)rows, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_rmsnorm(const void* x, const void* scale, void* out,
                          long long rows, int d, float eps, int dtype,
                          void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_BF16)
    return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
  if (dtype == RT_F32) return launch<float>(x, scale, out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
