// Error text for the cudaError_t codes the launch functions return.

#include <cuda_runtime.h>

extern "C" const char* diffus_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
