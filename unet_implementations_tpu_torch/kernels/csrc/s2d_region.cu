// K3: the fused tail of a space-to-depth ConvBlock, forward, for Hopper
// (sm_90a).
//
// Replaces unet_implementations_tpu/kernels/s2d_region.py::_pallas_tail (its
// _region_kernel):
//
//   y = lrelu(IN2(conv3x3(lrelu(IN1(x)), K)))
//
// on a q-major s2d tensor x (B, H', W', 4C) (channel q*C + c, q = dy*2 + dx,
// full-resolution pixel (2i+dy, 2j+dx)). Both InstanceNorms pool the four
// sub-pixels of each original channel. The conv is the 3x3 C->C conv of the
// full-resolution image, with zero padding and no bias: conv_1's bias shifts
// IN2's mean by exactly itself and cancels.
//
// The TPU kernel kept one whole image in VMEM (16 MB at 256^2 x 128 bf16);
// an SM has 227 KB. So the tail is four steps behind one entry point:
//
//   1. IN1 statistics: K1's statistics and finalize passes (group 4).
//   2. s2d_conv_kernel: a 3x3 conv in the full-resolution (dense) geometry,
//      which indexes the q-major tensor as the full image, so the 75% of the
//      s2d kernel that is structural zeros is never multiplied. A block owns
//      one strip of 8 full-resolution rows of one image and walks it in
//      8x16-pixel tiles. Per tile:
//      - prologue: the (8+2)x(16+2) input tile with its one-pixel halo is
//        loaded into shared memory through IN1's normalize, rounded to the
//        dtype and put through LeakyReLU in the dtype, in the plain
//        version's op order (the conv's inputs then equal the plain
//        version's for equal statistics); outside the image it is zero;
//      - the conv: bf16 on the tensor cores (wmma 16x16x16, float32
//        accumulators; M = 16 pixels of a tile row per warp, N = C, K = 9C,
//        channels padded to 16 with zeros), float32 on the CUDA cores (FMA,
//        no TF32), from weights resident in shared memory for the block;
//      - epilogue: the output rounded to the dtype is written in q-major
//        layout, and float32 sums of y and y*y (of the rounded values) build
//        per-thread, per-(q, channel) totals. After the strip the block
//        reduces them in a fixed order into its own row of partials, with
//        no atomics, so the bf16 forward repeats bit for bit.
//   3. IN2: K1's finalize over the strips' partials (group 4), then
//   4. K1's apply pass with LeakyReLU (which rounds once, after the
//      activation; the plain version rounds the norm and then activates in
//      the dtype: at most one ulp apart on negative values).
//
// Bound: bytes, one read of x and one write of y. The design moves about
// 4x that: x is read twice (statistics, conv) and y is written and read
// once more between the conv and IN2's apply pass. The conv's own bound is
// its 2*9*C^2 flops per full-resolution pixel on the tensor cores, about
// even with the bytes at 128^2 x 4*64; wmma from shared memory without a
// pipeline does not reach it. Making it fast (wgmma, TMA, fusing the IN2
// apply into the next layer) is later work.
#include <mma.h>

#include "instance_norm.cuh"

namespace unet {
namespace {

constexpr int kTileH = 8;                 // full-resolution rows of a tile (= a strip)
constexpr int kTileW = 16;                // full-resolution columns of a tile
constexpr int kTilePx = kTileH * kTileW;  // 128 pixels: one 16-pixel row per warp
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kThreads = 256;             // 8 warps
constexpr int kSums = 16;                 // per thread: 8 channels x (sum, sum of squares)

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Shared memory of one block, in bytes, laid out in this order.
template <typename T, int CP>
struct Smem {
  static constexpr size_t kWeights = align128(sizeof(T) * 9 * CP * CP);     // [tap][ci][co]
  static constexpr size_t kInput = align128(sizeof(T) * kHaloH * kHaloW * CP);
  static constexpr size_t kOutput =
      sizeof(T) == 2 ? align128(sizeof(float) * kTilePx * CP) : 0;          // wmma staging
  static constexpr size_t kReduce = align128(sizeof(float) * kThreads * kSums);
  static constexpr size_t kStats = align128(sizeof(float) * (2 * 4 * CP + 2 * CP));
  static constexpr size_t kTotal = kWeights + kInput + kOutput + kReduce + kStats;
};

// Eight consecutive values: one 16-byte access in bf16, two in float32.
template <typename T>
__device__ __forceinline__ Vec<T, 8> load8(const T* src) {
  if constexpr (sizeof(T) == 2) {
    return load_vec<T, 8>(src);
  } else {
    const Vec<T, 4> lo = load_vec<T, 4>(src), hi = load_vec<T, 4>(src + 4);
    Vec<T, 8> v;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v.v[k] = lo.v[k];
      v.v[k + 4] = hi.v[k];
    }
    return v;
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const Vec<T, 8>& v) {
  if constexpr (sizeof(T) == 2) {
    store_vec<T, 8>(dst, v);
  } else {
    Vec<T, 4> lo, hi;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      lo.v[k] = v.v[k];
      hi.v[k] = v.v[k + 4];
    }
    store_vec<T, 4>(dst, lo);
    store_vec<T, 4>(dst + 4, hi);
  }
}

// IN1 then LeakyReLU, with the plain version's roundings: the norm is
// rounded to T, and the activation runs in T (its slope rounded to T).
template <typename T>
__device__ __forceinline__ float in1_act(float v, float m, float rs, float sc, float bi,
                                         float slope_t) {
  float t = __fmul_rn(__fsub_rn(v, m), rs);
  t = round_to<T>(__fadd_rn(__fmul_rn(t, sc), bi));
  return t >= 0.f ? t : round_to<T>(__fmul_rn(t, slope_t));
}

// Offset of channel block q of full-resolution pixel (yy, xx) in the s2d tensor.
__device__ __forceinline__ long long s2d_pixel(long long b, int yy, int xx, int hp, int wp,
                                               int c) {
  const int q = (yy & 1) * 2 + (xx & 1);
  return ((b * hp + (yy >> 1)) * wp + (xx >> 1)) * 4LL * c + q * c;
}

// The tile's activated input with its halo: in_s[(r * kHaloW + col) * CP + ci],
// zero outside the image and for ci >= c. Vectors of 8 channels.
template <typename T, int CP>
__device__ void load_tile(const T* __restrict__ x, T* in_s, const float* mr_s, const float* sb_s,
                          long long b, int y0, int x0, int hf, int wf, int hp, int wp, int c,
                          float slope_t) {
  constexpr int kVecs = CP / 8;
  for (int i = threadIdx.x; i < kHaloH * kHaloW * kVecs; i += kThreads) {
    const int px = i / kVecs;
    const int ci0 = (i % kVecs) * 8;
    const int yy = y0 - 1 + px / kHaloW;
    const int xx = x0 - 1 + px % kHaloW;
    Vec<T, 8> vals;
    if (ci0 < c && yy >= 0 && yy < hf && xx >= 0 && xx < wf) {
      const int q = (yy & 1) * 2 + (xx & 1);
      const Vec<T, 8> in = load8<T>(x + s2d_pixel(b, yy, xx, hp, wp, c) + ci0);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int ch = q * c + ci0 + k;
        vals.v[k] = from_f32<T>(in1_act<T>(to_f32(in.v[k]), mr_s[ch], mr_s[4 * CP + ch],
                                            sb_s[ci0 + k], sb_s[CP + ci0 + k], slope_t));
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) vals.v[k] = from_f32<T>(0.f);
    }
    store8<T>(in_s + px * CP + ci0, vals);
  }
}

// Epilogue thread mapping: thread t takes channel group g = t % ng (8
// channels) of the pixels p = t / ng + k * (kThreads / ng). kThreads / ng is
// a multiple of 32, so every pixel of a thread has the same row parity
// (p / 16 moves in steps of 2) and column (p % 16): one q.
__device__ __forceinline__ int lane_q(int lane) { return ((lane / kTileW) & 1) * 2 + (lane & 1); }

// Round 8 accumulators of pixel p to T, write them in q-major layout and add
// them to the thread's sums.
template <typename T>
__device__ __forceinline__ void emit(T* __restrict__ y, const float* acc, long long b, int yy,
                                     int xx, int hp, int wp, int c, int ci0, float* sums) {
  Vec<T, 8> out;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    out.v[k] = from_f32<T>(acc[k]);
    const float r = to_f32(out.v[k]);
    sums[k] += r;
    sums[8 + k] += r * r;
  }
  store8<T>(y + s2d_pixel(b, yy, xx, hp, wp, c) + ci0, out);
}

// bf16: warp w multiplies tile row w (16 pixels) by all CP output channels
// with wmma, and stages the float32 accumulators in out_s [pixel][CP].
template <int CP>
__device__ void conv_tile_wmma(const __nv_bfloat16* in_s, const __nv_bfloat16* w_s,
                               float* out_s) {
  using namespace nvcuda;
  constexpr int kN = CP / 16;
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) wmma::fill_fragment(acc[n], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    const __nv_bfloat16* a_row = in_s + ((warp + ky) * kHaloW + kx) * CP;
#pragma unroll
    for (int kc = 0; kc < CP / 16; ++kc) {
      wmma::load_matrix_sync(a, a_row + kc * 16, CP);
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        wmma::load_matrix_sync(bf, w_s + (tap * CP + kc * 16) * CP + n * 16, CP);
        wmma::mma_sync(acc[n], a, bf, acc[n]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    wmma::store_matrix_sync(out_s + warp * 16 * CP + n * 16, acc[n], CP, wmma::mem_row_major);
  }
}

// float32: the thread's pixels (see lane_q) times its 8 output channels, FMA
// on the CUDA cores.
template <int CP, int PPT>
__device__ __forceinline__ void conv_pixels_f32(const float* in_s, const float* w_s, int lane,
                                                int lanes, int ci_group, float (*acc)[8]) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;
  }
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    for (int ci = 0; ci < CP; ++ci) {
      const float* wrow = w_s + (tap * CP + ci) * CP + ci_group * 8;
      const float4 w0 = *reinterpret_cast<const float4*>(wrow);
      const float4 w1 = *reinterpret_cast<const float4*>(wrow + 4);
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int p = lane + k * lanes;
        const float a = in_s[((p / kTileW + ky) * kHaloW + p % kTileW + kx) * CP + ci];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[k][j] = fmaf(a, wv[j], acc[k][j]);
      }
    }
  }
}

// grid (strips, B): block (s, b) computes full-resolution rows [8s, 8s+8) of
// image b, and writes its partials row (b, s): sums of y and y*y per q-major
// channel.
template <typename T, int CP>
__global__ void __launch_bounds__(kThreads)
s2d_conv_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ mean1,
                const float* __restrict__ rstd1, const float* __restrict__ scale1,
                const float* __restrict__ bias1, T* __restrict__ y, float* __restrict__ partials,
                int hp, int wp, int c, float slope) {
  using S = Smem<T, CP>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* w_s = reinterpret_cast<T*>(smem);
  T* in_s = reinterpret_cast<T*>(smem + S::kWeights);
  float* out_s = reinterpret_cast<float*>(smem + S::kWeights + S::kInput);
  float* red_s = reinterpret_cast<float*>(smem + S::kWeights + S::kInput + S::kOutput);
  // IN1's mean [4CP] and rstd [4CP] of this image by q-major channel
  // (q * c + ci), then scale [CP] and bias [CP].
  float* mr_s = reinterpret_cast<float*>(smem + S::kWeights + S::kInput + S::kOutput +
                                         S::kReduce);
  float* sb_s = mr_s + 8 * CP;

  const int strip = blockIdx.x;
  const long long b = blockIdx.y;
  const int hf = 2 * hp, wf = 2 * wp;
  const int c4 = 4 * c;
  const float slope_t = round_to<T>(slope);

  // Weights (3, 3, c, c) -> [tap][ci][co], zero-padded to CP x CP.
  for (int i = threadIdx.x; i < 9 * CP * CP; i += kThreads) {
    const int tap = i / (CP * CP), ci = (i / CP) % CP, co = i % CP;
    w_s[i] = (ci < c && co < c) ? w[(tap * c + ci) * c + co] : from_f32<T>(0.f);
  }
  for (int i = threadIdx.x; i < c4; i += kThreads) {
    mr_s[i] = mean1[b * c4 + i];
    mr_s[4 * CP + i] = rstd1[b * c4 + i];
  }
  for (int i = threadIdx.x; i < c; i += kThreads) {
    sb_s[i] = scale1[i];
    sb_s[CP + i] = bias1[i];
  }
  __syncthreads();

  const int ng = c / 8;
  const int lanes = kThreads / ng;
  const int g = threadIdx.x % ng;
  const int lane = threadIdx.x / ng;
  float sums[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) sums[k] = 0.f;

  const int y0 = strip * kTileH;
  for (int x0 = 0; x0 < wf; x0 += kTileW) {
    load_tile<T, CP>(x, in_s, mr_s, sb_s, b, y0, x0, hf, wf, hp, wp, c, slope_t);
    __syncthreads();
    if constexpr (sizeof(T) == 2) {
      conv_tile_wmma<CP>(in_s, w_s, out_s);
      __syncthreads();
      for (int p = lane; p < kTilePx; p += lanes) {
        const int yy = y0 + p / kTileW, xx = x0 + p % kTileW;
        if (yy < hf && xx < wf) {
          emit<T>(y, out_s + p * CP + g * 8, b, yy, xx, hp, wp, c, g * 8, sums);
        }
      }
    } else {
      constexpr int kMaxPpt = CP >= 64 ? 4 : (CP >= 32 ? 2 : 1);
      float acc[kMaxPpt][8];
      if (lane < kTilePx) {
        conv_pixels_f32<CP, kMaxPpt>(reinterpret_cast<const float*>(in_s),
                                     reinterpret_cast<const float*>(w_s), lane, lanes, g, acc);
#pragma unroll
        for (int k = 0; k < kMaxPpt; ++k) {
          const int p = lane + k * lanes;
          const int yy = y0 + p / kTileW, xx = x0 + p % kTileW;
          if (p < kTilePx && yy < hf && xx < wf) {
            emit<T>(y, acc[k], b, yy, xx, hp, wp, c, g * 8, sums);
          }
        }
      }
    }
    __syncthreads();
  }

  // The strip's sums per q-major channel, in a fixed order.
#pragma unroll
  for (int k = 0; k < kSums; ++k) red_s[threadIdx.x * kSums + k] = sums[k];
  __syncthreads();
  float* out = partials + (b * gridDim.x + strip) * 2LL * c4;
  for (int o = threadIdx.x; o < c4; o += kThreads) {
    const int q = o / c, ch = o % c;
    const int og = ch / 8, k = ch % 8;
    float s1 = 0.f, s2 = 0.f;
    for (int l = 0; l < lanes && l < kTilePx; ++l) {
      if (lane_q(l) != q) continue;
      const float* r = red_s + (l * ng + og) * kSums;
      s1 += r[k];
      s2 += r[8 + k];
    }
    out[o] = s1;
    out[c4 + o] = s2;
  }
}

template <typename T, int CP>
cudaError_t launch_conv(const void* x, const void* w, const float* mean1, const float* rstd1,
                        const float* scale1, const float* bias1, void* y, float* partials,
                        long long b, int hp, int wp, int c, int nstrips, float slope,
                        cudaStream_t stream) {
  constexpr size_t kSmem = Smem<T, CP>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(s2d_conv_kernel<T, CP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  s2d_conv_kernel<T, CP><<<dim3(nstrips, static_cast<unsigned>(b)), kThreads, kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), mean1, rstd1, scale1, bias1,
      static_cast<T*>(y), partials, hp, wp, c, slope);
  return cudaGetLastError();
}

cudaError_t conv(const void* x, const void* w, const float* mean1, const float* rstd1,
                 const float* scale1, const float* bias1, void* y, float* partials, int dtype,
                 long long b, int hp, int wp, int c, int nstrips, float slope,
                 cudaStream_t stream) {
  if (dtype == kBFloat16) {
    using T = __nv_bfloat16;
    switch (c) {
      case 8:
      case 16:
        return launch_conv<T, 16>(x, w, mean1, rstd1, scale1, bias1, y, partials, b, hp, wp, c,
                                  nstrips, slope, stream);
      case 32:
        return launch_conv<T, 32>(x, w, mean1, rstd1, scale1, bias1, y, partials, b, hp, wp, c,
                                  nstrips, slope, stream);
      case 64:
        return launch_conv<T, 64>(x, w, mean1, rstd1, scale1, bias1, y, partials, b, hp, wp, c,
                                  nstrips, slope, stream);
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (dtype == kFloat32) {
    switch (c) {
      case 8:
        return launch_conv<float, 8>(x, w, mean1, rstd1, scale1, bias1, y, partials, b, hp, wp,
                                     c, nstrips, slope, stream);
      case 16:
        return launch_conv<float, 16>(x, w, mean1, rstd1, scale1, bias1, y, partials, b, hp,
                                      wp, c, nstrips, slope, stream);
      case 32:
        return launch_conv<float, 32>(x, w, mean1, rstd1, scale1, bias1, y, partials, b, hp,
                                      wp, c, nstrips, slope, stream);
      case 64:
        return launch_conv<float, 64>(x, w, mean1, rstd1, scale1, bias1, y, partials, b, hp,
                                      wp, c, nstrips, slope, stream);
      default:
        return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace unet

// x: (B, H', W', 4C) q-major, contiguous, float32 or bfloat16 (`dtype`);
// C in {8, 16, 32, 64}. w: conv_1's kernel as (3, 3, C_in, C_out) in x's
// dtype. scale*, bias*: (C,) float32. Scratch, float32: partials1 (B,
// nchunk1, 2, 4C), mean1/rstd1/mean2/rstd2 (B, 4C), partials2 (B, nstrips,
// 2, 4C) with nstrips = ceil(2H' / 8). y_conv (the conv output) and out are
// shaped as x. chunk_px * nchunk1 >= H'W'.
extern "C" int unet_s2d_tail_fwd(const void* x, const void* w, const void* scale1,
                                 const void* bias1, const void* scale2, const void* bias2,
                                 void* y_conv, void* out, void* partials1, void* mean1,
                                 void* rstd1, void* partials2, void* mean2, void* rstd2, int dtype,
                                 long long b, int hp, int wp, int c, int chunk_px, int nchunk1,
                                 int nstrips, float eps, float slope, void* stream) {
  const long long hw = static_cast<long long>(hp) * wp;
  if (b <= 0 || b > 65535 || hp <= 0 || wp <= 0 || c <= 0 || c % 8 != 0 || chunk_px <= 0 ||
      nchunk1 <= 0 || static_cast<long long>(chunk_px) * nchunk1 < hw ||
      nstrips != (2 * hp + unet::kTileH - 1) / unet::kTileH) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto p1 = static_cast<float*>(partials1);
  auto m1 = static_cast<float*>(mean1);
  auto r1 = static_cast<float*>(rstd1);
  auto p2 = static_cast<float*>(partials2);
  auto m2 = static_cast<float*>(mean2);
  auto r2 = static_cast<float*>(rstd2);
  const int c4 = 4 * c;
  const float n = static_cast<float>(4 * hw);
  cudaError_t err = unet::in_stats(x, dtype, p1, b, hw, c4, chunk_px, nchunk1, s);
  if (err != cudaSuccess) return err;
  err = unet::in_finalize(p1, m1, r1, b, nchunk1, c4, 4, n, eps, s);
  if (err != cudaSuccess) return err;
  err = unet::conv(x, w, m1, r1, static_cast<const float*>(scale1),
                   static_cast<const float*>(bias1), y_conv, p2, dtype, b, hp, wp, c, nstrips,
                   slope, s);
  if (err != cudaSuccess) return err;
  err = unet::in_finalize(p2, m2, r2, b, nstrips, c4, 4, n, eps, s);
  if (err != cudaSuccess) return err;
  return unet::in_apply(y_conv, out, dtype, m2, r2, static_cast<const float*>(scale2),
                        static_cast<const float*>(bias2), b, hw, c4, 4, slope, s);
}
