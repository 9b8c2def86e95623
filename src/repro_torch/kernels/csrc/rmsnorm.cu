// Fused RMSNorm for Hopper.
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm_pallas (body
// _rmsnorm_kernel): f32 mean of squares over the last axis, then
// x * rsqrt(mean + eps) * scale, cast to x's dtype on write.
//
// Bound on this card: bytes. It reads each row once and writes it once
// (2 * rows * d * sizeof(T)) for ~4 flops per element, far below the
// H100's ~295 flops/byte ridge. Design: one block per row, so a row's
// sum of squares is one warp-shuffle reduction plus one step across the
// block's warps through shared memory, with no second pass over device
// memory; the second read of the row for the scaled write hits L1/L2.
// The scale is always float32 (the model keeps norm scales in f32, as
// the reference multiplies by the f32 master scale).
#include "common.cuh"

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
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

extern "C" int rt_rmsnorm(const void* x, const void* scale, void* out,
                          long long rows, int d, float eps, int dtype,
                          void* stream) {
  if (rows <= 0) return 0;
  const int threads = d >= 2048 ? 256 : (d >= 512 ? 128 : 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == RT_BF16) {
    rmsnorm_kernel<__nv_bfloat16><<<(unsigned)rows, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out),
        d, eps);
  } else if (dtype == RT_F32) {
    rmsnorm_kernel<float><<<(unsigned)rows, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(out), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
