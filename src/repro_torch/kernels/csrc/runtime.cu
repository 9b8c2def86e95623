// Error strings for the CUDA error codes the launch functions return.
#include <cuda_runtime.h>

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
