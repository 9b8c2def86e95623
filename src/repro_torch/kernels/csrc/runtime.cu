// Error strings for the CUDA error codes the launch functions return, and
// the attributes of a kernel named by a launch plan (plan.cuh).
#include <cuda_runtime.h>

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Fills out[0..7] for the kernel func (an RtLaunch's func) launched with
// block_threads threads and smem bytes of dynamic shared memory:
// registers a thread, static shared memory, local memory a thread (spills
// and stack), the most threads a block, the most dynamic shared memory a
// block may opt in to, resident blocks an SM at this block and smem (the
// kernel is opted in to smem first, as its launch does), the card's
// opt-in shared memory a block, and its SM count. Returns a CUDA error
// code.
extern "C" int rt_kernel_attributes(const void* func, int block_threads,
                                    unsigned long long smem,
                                    long long* out) {
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(func, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, func);
  if (e != cudaSuccess) return static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, func,
                                                    block_threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, optin = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = (long long)a.sharedSizeBytes;
  out[2] = (long long)a.localSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  out[4] = a.maxDynamicSharedSizeBytes;
  out[5] = blocks;
  out[6] = optin;
  out[7] = sms;
  return 0;
}
