// Shared helpers for the port's kernels: 16-byte vectors of activations and
// the float conversions. Every kernel takes NHWC-contiguous activations in
// bfloat16 or float32 and computes in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace unet {

// dtype codes shared with the Python wrappers (kernels/_build.py; float16
// only in kernels/fp8_conv.py).
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const Vec<T, VEC>& v) {
  *reinterpret_cast<Vec<T, VEC>*>(p) = v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round a float32 value to T and back: the ".astype(dtype)" of the plain
// version, kept in a float register.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Widest vector (elements per 16-byte access) that divides `c` and that the
// pointers' alignment allows; 1 otherwise.
template <typename T>
inline int vec_width(int c, const void* a, const void* b) {
  const int v = 16 / static_cast<int>(sizeof(T));
  const bool aligned = (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(b) % 16 == 0);
  return (aligned && c % v == 0) ? v : 1;
}

inline int grid_for(long long n, int threads, int max_blocks) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

}  // namespace unet
