// The CUDA runtime's message for an error code that an entry point of this
// library returned, for the Python wrappers' exceptions.
#include <cuda_runtime.h>

extern "C" const char* unet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
