// K2: exact 2x bilinear upsample, dense NHWC, forward, for Hopper (sm_90a).
//
// Replaces unet_implementations_tpu/kernels/upsample.py::
// _upsample2x_dense_pallas (its _dense_kernel).
//
// Torch half-pixel sampling (align_corners=False), edge-clamped: along each
// axis the even output is 0.25*x[i-1] + 0.75*x[i] and the odd output is
// 0.75*x[i] + 0.25*x[i+1], computed in float32 and rounded to the input dtype
// after each axis (H first, then W), exactly as the plain version
// (ops/resize.py::lerp2_taps) does. The products and the sum are rounded
// separately (__fmul_rn / __fadd_rn) so that nvcc cannot contract them into
// an FMA: the result is bitwise equal to the plain version.
//
// Bound: bytes. One read of x and one write of the 4x larger output; about
// 12 flops an output element. Each thread owns one input pixel and 16 bytes
// of its channels: it reads the pixel's edge-clamped 3x3 neighbourhood (the
// +-1 halo rows and columns), forms the four sub-pixel phases in registers
// and writes them straight into the interleaved (2H, 2W) output, so no
// intermediate touches device memory. Neighbouring threads take neighbouring
// channels, then neighbouring pixels of the same input row, so a block
// covers a contiguous span of one row; the halo reads of the rows above and
// below hit L1/L2, not device memory.
#include "common.cuh"

namespace unet {
namespace {

constexpr int kMaxBlocks = 132 * 16;

// The two lerps of one axis on float values already rounded to T.
template <typename T>
__device__ __forceinline__ float lerp_even(float prev, float cur) {
  return round_to<T>(__fadd_rn(__fmul_rn(0.25f, prev), __fmul_rn(0.75f, cur)));
}
template <typename T>
__device__ __forceinline__ float lerp_odd(float cur, float next) {
  return round_to<T>(__fadd_rn(__fmul_rn(0.75f, cur), __fmul_rn(0.25f, next)));
}

template <typename T, int VEC>
__global__ void upsample2x_kernel(const T* __restrict__ x, T* __restrict__ y, int h, int w,
                                  int c, long long nvec) {
  const int tc = c / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < nvec;
       i += stride) {
    const int cv = static_cast<int>(i % tc);
    const long long pix = i / tc;
    const int col = static_cast<int>(pix % w);
    const long long bh = pix / w;
    const int row = static_cast<int>(bh % h);
    const long long b = bh / h;

    const int rows[3] = {max(row - 1, 0), row, min(row + 1, h - 1)};
    const int cols[3] = {max(col - 1, 0), col, min(col + 1, w - 1)};
    const T* xb = x + b * h * w * c + cv * VEC;
    Vec<T, VEC> in[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        in[r][q] = load_vec<T, VEC>(xb + (static_cast<long long>(rows[r]) * w + cols[q]) * c);
      }
    }
    Vec<T, VEC> ee, eo, oe, oo;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float ev[3], od[3];  // H-axis lerps at columns col-1, col, col+1
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float above = to_f32(in[0][q].v[k]);
        const float mid = to_f32(in[1][q].v[k]);
        const float below = to_f32(in[2][q].v[k]);
        ev[q] = lerp_even<T>(above, mid);
        od[q] = lerp_odd<T>(mid, below);
      }
      ee.v[k] = from_f32<T>(lerp_even<T>(ev[0], ev[1]));
      eo.v[k] = from_f32<T>(lerp_odd<T>(ev[1], ev[2]));
      oe.v[k] = from_f32<T>(lerp_even<T>(od[0], od[1]));
      oo.v[k] = from_f32<T>(lerp_odd<T>(od[1], od[2]));
    }
    const long long w2 = 2LL * w;
    T* top = y + ((b * 2 * h + 2LL * row) * w2 + 2LL * col) * c + cv * VEC;
    T* bot = top + w2 * c;
    store_vec<T, VEC>(top, ee);
    store_vec<T, VEC>(top + c, eo);
    store_vec<T, VEC>(bot, oe);
    store_vec<T, VEC>(bot + c, oo);
  }
}

template <typename T, int VEC>
cudaError_t launch(const T* x, T* y, long long b, int h, int w, int c, cudaStream_t stream) {
  const long long nvec = b * h * w * c / VEC;
  upsample2x_kernel<T, VEC><<<grid_for(nvec, 256, kMaxBlocks), 256, 0, stream>>>(x, y, h, w, c,
                                                                                nvec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t forward(const void* xv, void* yv, long long b, int h, int w, int c,
                    cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  constexpr int kWide = 16 / sizeof(T);
  return vec_width<T>(c, xv, yv) == kWide ? launch<T, kWide>(x, y, b, h, w, c, stream)
                                          : launch<T, 1>(x, y, b, h, w, c, stream);
}

}  // namespace
}  // namespace unet

// x: (B, H, W, C) contiguous; y: (B, 2H, 2W, C) contiguous; float32 or
// bfloat16 (`dtype`, see common.cuh).
extern "C" int unet_upsample2x_fwd(const void* x, void* y, int dtype, long long b, int h, int w,
                                   int c, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case unet::kFloat32:
      return unet::forward<float>(x, y, b, h, w, c, s);
    case unet::kBFloat16:
      return unet::forward<__nv_bfloat16>(x, y, b, h, w, c, s);
    default:
      return cudaErrorInvalidValue;
  }
}
