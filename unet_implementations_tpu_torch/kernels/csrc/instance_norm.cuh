// K1's passes (instance_norm.cu) as launchers, for the other kernels of this
// library that normalize with the same code: the s2d block tail
// (s2d_region.cu) runs them with group = 4 around its conv. K1's own forward
// folds the finalize into its statistics pass instead.
//
// x, y: (B, H*W, C) contiguous, `dtype` a DType code. partials: (B, nchunk,
// 2, C) float32, [.., 0, :] the sums of x and [.., 1, :] those of x*x.
// mean, rstd: (B, C) float32, each original channel's value repeated over
// its `group` q-major blocks. scale, bias: (C / group,) float32. `n` is the
// number of values each original channel pools. Each launcher returns
// cudaGetLastError() after its launch.
#pragma once

#include "common.cuh"

namespace unet {

cudaError_t in_stats(const void* x, int dtype, float* partials, long long b, long long hw, int c,
                     int chunk_px, int nchunk, cudaStream_t stream);

cudaError_t in_finalize(const float* partials, float* mean, float* rstd, long long b,
                        int nchunk, int c, int group, float n, float eps, cudaStream_t stream);

cudaError_t in_apply(const void* x, void* y, int dtype, const float* mean, const float* rstd,
                     const float* scale, const float* bias, long long b, long long hw, int c,
                     int group, float slope, cudaStream_t stream);

}  // namespace unet
