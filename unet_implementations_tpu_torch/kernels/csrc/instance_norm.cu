// K1: fused InstanceNorm + LeakyReLU forward, for Hopper (sm_90a).
//
// Replaces unet_implementations_tpu/kernels/instance_norm.py::_pallas_forward
// (its two pallas_calls, _stats_kernel and _normalize_kernel).
//
//   y = lrelu((x - mean) * rstd * scale + bias)        per (image, channel)
//
// mean and the biased variance come from float32 sums of x and x*x over H*W
// (and over the `group` q-major sub-pixel blocks, channel = q*Cg + c, when
// group > 1); rstd = 1/sqrt(var + eps). y is computed in float32 and rounded
// once to x's dtype.
//
// Bound: bytes. Per call the work must read x once and write y once; at
// 2 bytes an element (bf16) that is 4 bytes per element against ~10 flops,
// far below the card's ~295 flops/byte balance point. The statistics need a
// full pass over x before any y can be written, so the design reads x twice:
//
//   1. in_stats_kernel: blocks tile (image, chunk of H*W pixels). Threads of a
//      block cover one pixel row of C channels with 16-byte loads (C is
//      innermost in NHWC, so neighbouring threads read neighbouring
//      channels); the block's rows stride over its chunk. Each block writes
//      float32 partial sums to a (B, nchunk, 2, C) scratch. The TPU version
//      carried the sums in VMEM across a sequential grid; Hopper's blocks run
//      in no order, so partials replace the carried sum, and no atomics are
//      used so that runs repeat bit for bit.
//   2. in_finalize_kernel: sums the partials in a fixed order, pools the
//      group, and writes mean and rstd per (image, channel).
//   3. in_apply_kernel: one read of x and one write of y, 16 bytes a thread.
//
// The second read of x in pass 3 is the price over the one-read-one-write
// bound (at most 1.5x); a chunk of an image that fits in L2 may be served
// from there.
#include "instance_norm.cuh"

namespace unet {
namespace {

constexpr int kStatsThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

template <typename T, int VEC>
__global__ void in_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                                long long hw, int c, int chunk_px, int nchunk) {
  extern __shared__ float smem[];
  const int tc = c / VEC;             // threads across one pixel's channels
  const int rows = blockDim.x / tc;   // pixel rows the block covers at once
  const int t = threadIdx.x;
  const int cv = t % tc;
  const int r = t / tc;
  const int chunk = blockIdx.x;
  const long long b = blockIdx.y;
  const long long p0 = static_cast<long long>(chunk) * chunk_px;
  const long long p1 = min(p0 + chunk_px, hw);

  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) { s1[k] = 0.f; s2[k] = 0.f; }
  const T* xb = x + b * hw * c + cv * VEC;
  for (long long p = p0 + r; p < p1; p += rows) {
    const Vec<T, VEC> v = load_vec<T, VEC>(xb + p * c);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float f = to_f32(v.v[k]);
      s1[k] += f;
      s2[k] += f * f;
    }
  }
  float* sm1 = smem;               // [rows][c]
  float* sm2 = smem + rows * c;    // [rows][c]
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sm1[r * c + cv * VEC + k] = s1[k];
    sm2[r * c + cv * VEC + k] = s2[k];
  }
  __syncthreads();
  float* out = partials + (b * nchunk + chunk) * 2 * c;
  for (int ch = t; ch < c; ch += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int rr = 0; rr < rows; ++rr) {
      a += sm1[rr * c + ch];
      q += sm2[rr * c + ch];
    }
    out[ch] = a;
    out[c + ch] = q;
  }
}

// grid (ceil(cg / 32), B), block (32, 8): x walks channels, y walks chunks.
__global__ void in_finalize_kernel(const float* __restrict__ partials,
                                   float* __restrict__ mean, float* __restrict__ rstd,
                                   int nchunk, int c, int group, float n, float eps) {
  __shared__ float red1[8][32];
  __shared__ float red2[8][32];
  const int cg_count = c / group;
  const int cg = blockIdx.x * 32 + threadIdx.x;
  const long long b = blockIdx.y;
  float a = 0.f, q = 0.f;
  if (cg < cg_count) {
    for (int k = threadIdx.y; k < nchunk; k += 8) {
      const float* row = partials + (b * nchunk + k) * 2 * c;
      for (int g = 0; g < group; ++g) {
        a += row[g * cg_count + cg];
        q += row[c + g * cg_count + cg];
      }
    }
  }
  red1[threadIdx.y][threadIdx.x] = a;
  red2[threadIdx.y][threadIdx.x] = q;
  __syncthreads();
  if (threadIdx.y == 0 && cg < cg_count) {
    for (int y = 1; y < 8; ++y) {
      a += red1[y][threadIdx.x];
      q += red2[y][threadIdx.x];
    }
    // Same op order as the plain version: s1/n, s2/n - m*m, no contraction.
    const float m = __fdiv_rn(a, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(q, n), __fmul_rn(m, m)), 0.f);
    const float rs = __frsqrt_rn(__fadd_rn(var, eps));
    for (int g = 0; g < group; ++g) {
      mean[b * c + g * cg_count + cg] = m;
      rstd[b * c + g * cg_count + cg] = rs;
    }
  }
}

template <typename T, int VEC>
__global__ void in_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                                const float* __restrict__ mean, const float* __restrict__ rstd,
                                const float* __restrict__ scale, const float* __restrict__ bias,
                                long long hw, int c, int cg_count, float slope, long long nvec) {
  const int tc = c / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < nvec;
       i += stride) {
    const int c0 = static_cast<int>(i % tc) * VEC;
    const long long b = (i / tc) / hw;
    const Vec<T, VEC> v = load_vec<T, VEC>(x + i * VEC);
    Vec<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int ch = c0 + k;
      const int pc = ch % cg_count;
      float t = __fmul_rn(__fsub_rn(to_f32(v.v[k]), mean[b * c + ch]), rstd[b * c + ch]);
      t = __fadd_rn(__fmul_rn(t, scale[pc]), bias[pc]);
      t = t >= 0.f ? t : __fmul_rn(t, slope);
      o.v[k] = from_f32<T>(t);
    }
    store_vec<T, VEC>(y + i * VEC, o);
  }
}

template <typename T, int VEC>
cudaError_t launch_stats(const T* x, float* partials, long long b, long long hw, int c,
                         int chunk_px, int nchunk, cudaStream_t stream) {
  const int tc = c / VEC;
  const int rows = tc >= kStatsThreads ? 1 : kStatsThreads / tc;
  const int threads = tc * rows;
  const size_t smem = static_cast<size_t>(2) * rows * c * sizeof(float);
  if (threads > 1024 || smem > 48 * 1024) return cudaErrorInvalidValue;
  in_stats_kernel<T, VEC><<<dim3(nchunk, static_cast<unsigned>(b)), threads, smem, stream>>>(
      x, partials, hw, c, chunk_px, nchunk);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_apply(const T* x, T* y, const float* mean, const float* rstd,
                         const float* scale, const float* bias, long long b, long long hw, int c,
                         int group, float slope, cudaStream_t stream) {
  const long long nvec = b * hw * c / VEC;
  in_apply_kernel<T, VEC><<<grid_for(nvec, 256, kMaxBlocks), 256, 0, stream>>>(
      x, y, mean, rstd, scale, bias, hw, c, c / group, slope, nvec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t stats(const void* xv, float* partials, long long b, long long hw, int c,
                  int chunk_px, int nchunk, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  constexpr int kWide = 16 / sizeof(T);
  return vec_width<T>(c, xv, xv) == kWide
      ? launch_stats<T, kWide>(x, partials, b, hw, c, chunk_px, nchunk, stream)
      : launch_stats<T, 1>(x, partials, b, hw, c, chunk_px, nchunk, stream);
}

template <typename T>
cudaError_t apply(const void* xv, void* yv, const float* mean, const float* rstd,
                  const float* scale, const float* bias, long long b, long long hw, int c,
                  int group, float slope, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  constexpr int kWide = 16 / sizeof(T);
  return vec_width<T>(c, xv, yv) == kWide
      ? launch_apply<T, kWide>(x, y, mean, rstd, scale, bias, b, hw, c, group, slope, stream)
      : launch_apply<T, 1>(x, y, mean, rstd, scale, bias, b, hw, c, group, slope, stream);
}

}  // namespace

cudaError_t in_stats(const void* x, int dtype, float* partials, long long b, long long hw, int c,
                     int chunk_px, int nchunk, cudaStream_t stream) {
  switch (dtype) {
    case kFloat32:
      return stats<float>(x, partials, b, hw, c, chunk_px, nchunk, stream);
    case kBFloat16:
      return stats<__nv_bfloat16>(x, partials, b, hw, c, chunk_px, nchunk, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t in_finalize(const float* partials, float* mean, float* rstd, long long b,
                        int nchunk, int c, int group, float n, float eps, cudaStream_t stream) {
  in_finalize_kernel<<<dim3((c / group + 31) / 32, static_cast<unsigned>(b)), dim3(32, 8), 0,
                       stream>>>(partials, mean, rstd, nchunk, c, group, n, eps);
  return cudaGetLastError();
}

cudaError_t in_apply(const void* x, void* y, int dtype, const float* mean, const float* rstd,
                     const float* scale, const float* bias, long long b, long long hw, int c,
                     int group, float slope, cudaStream_t stream) {
  switch (dtype) {
    case kFloat32:
      return apply<float>(x, y, mean, rstd, scale, bias, b, hw, c, group, slope, stream);
    case kBFloat16:
      return apply<__nv_bfloat16>(x, y, mean, rstd, scale, bias, b, hw, c, group, slope, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace unet

// x, y: (B, H*W, C) contiguous, float32 or bfloat16 (`dtype`, see common.cuh).
// scale, bias: (C / group,) float32. partials: (B, nchunk, 2, C) float32
// scratch; mean, rstd: (B, C) float32 outputs. chunk_px * nchunk >= H*W.
extern "C" int unet_instance_norm_fwd(const void* x, void* y, const void* scale,
                                      const void* bias, void* partials, void* mean, void* rstd,
                                      int dtype, long long b, long long hw, int c, int group,
                                      int chunk_px, int nchunk, float eps, float slope,
                                      void* stream) {
  if (b <= 0 || b > 65535 || hw <= 0 || c <= 0 || group <= 0 || c % group != 0 ||
      nchunk <= 0 || chunk_px <= 0 || static_cast<long long>(chunk_px) * nchunk < hw) {
    return cudaErrorInvalidValue;
  }
  if (dtype != unet::kFloat32 && dtype != unet::kBFloat16) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<float*>(partials);
  auto me = static_cast<float*>(mean);
  auto rs = static_cast<float*>(rstd);
  cudaError_t err = unet::in_stats(x, dtype, pa, b, hw, c, chunk_px, nchunk, s);
  if (err != cudaSuccess) return err;
  err = unet::in_finalize(pa, me, rs, b, nchunk, c, group, static_cast<float>(hw * group), eps, s);
  if (err != cudaSuccess) return err;
  return unet::in_apply(x, y, dtype, me, rs, static_cast<const float*>(scale),
                        static_cast<const float*>(bias), b, hw, c, group, slope, s);
}
