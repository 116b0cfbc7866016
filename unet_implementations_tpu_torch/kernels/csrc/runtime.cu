// The CUDA runtime's message for an error code that an entry point of this
// library returned, for the Python wrappers' exceptions; and the device's
// limits that the plans of the persistent kernels read.
#include <cuda_runtime.h>

extern "C" const char* unet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The current device's SM count and the shared memory a block may take after
// an opt-in, for the plans of the persistent kernels (one block per SM).
extern "C" int unet_device_limits(int* sms, int* smem_per_block) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return err;
}
