// Error text for the codes the kernels' C entries return.

#include <cuda_runtime.h>

extern "C" const char* crdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
