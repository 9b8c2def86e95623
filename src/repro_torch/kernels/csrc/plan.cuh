// Launch plans. Every kernel launch of the port is described by one
// RtLaunch: the kernel, a readable name, its grid, its block and its
// dynamic shared memory. In each source one host dispatch function makes
// the body choice and one plan_* function per kernel does the launch
// arithmetic; the launch site (<<<...>>>) and the source's extern "C"
// plan export (rt_*_plan) both go through them, so the plan a caller reads
// is the geometry that launches. kernels/plan.py holds the same plans in
// Python, and chip_smoke.py holds the two against each other.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>

struct RtLaunch {
  const void* func;          // the kernel (cudaFuncGetAttributes, occupancy)
  char name[96];             // e.g. "flash_fwd_mma<128>"
  unsigned grid[3];
  unsigned block[3];
  unsigned long long smem;   // dynamic shared memory, bytes
};

inline RtLaunch rt_plan(const void* func, dim3 grid, dim3 block, size_t smem,
                        const char* fmt, ...) {
  RtLaunch p;
  p.func = func;
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(p.name, sizeof(p.name), fmt, ap);
  va_end(ap);
  p.grid[0] = grid.x;
  p.grid[1] = grid.y;
  p.grid[2] = grid.z;
  p.block[0] = block.x;
  p.block[1] = block.y;
  p.block[2] = block.z;
  p.smem = smem;
  return p;
}

inline dim3 rt_grid(const RtLaunch& p) {
  return dim3(p.grid[0], p.grid[1], p.grid[2]);
}
inline dim3 rt_block(const RtLaunch& p) {
  return dim3(p.block[0], p.block[1], p.block[2]);
}

// Opts the kernel in to the plan's dynamic shared memory past the default
// 48 KiB; returns a CUDA error code.
inline int rt_smem_optin(const RtLaunch& p) {
  if (p.smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      p.func, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem));
}

// Collects the plans of a call for an rt_*_plan export: at most cap
// launches into out; n counts them all.
struct RtPlanSink {
  RtLaunch* out;
  int cap;
  int n;
  void add(const RtLaunch& p) {
    if (n < cap) out[n] = p;
    ++n;
  }
};

template <typename T>
inline const char* rt_tname();
template <>
inline const char* rt_tname<float>() { return "f32"; }
template <>
inline const char* rt_tname<__nv_bfloat16>() { return "bf16"; }
template <>
inline const char* rt_tname<int8_t>() { return "int8"; }

inline bool rt_aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}
