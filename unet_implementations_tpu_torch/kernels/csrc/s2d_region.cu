// K3: the fused tail of a space-to-depth ConvBlock, forward, for Hopper
// (sm_90a).
//
// Replaces unet_implementations_tpu/kernels/s2d_region.py::_pallas_tail (:204,
// its pallas_call at :220): _region_kernel (:74), with conv_1's kernel
// stacked by _stack_w2 (:161), taken where region_applicable (:189) allows:
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
//   2. The conv, in the full-resolution (dense) geometry, indexing the
//      q-major tensor as the full image, so the 75% of the s2d kernel that is
//      structural zeros is never multiplied. It normalizes and activates its
//      input as it loads it, and sums IN2's statistics of its rounded output.
//   3. IN2: K1's finalize over the conv's partials (group 4), then
//   4. K1's apply pass with LeakyReLU (which rounds once, after the
//      activation; the plain version rounds the norm and then activates in
//      the dtype: at most one ulp apart on negative values).
//
// Bounds (the three calls of a b128 512^2 s2d forward, H100 SXM): bytes, one
// read of x and one write of y, 3.2 ms for the whole tail and the same for
// the conv launch (read x, write y_conv); the conv's 2*9*C^2 flops per
// full-resolution pixel at the bf16 tensor rate, 1.88 ms.
//
// The bf16 conv (s2d_conv_wgmma_kernel): a persistent, warp-specialised
// implicit GEMM on wgmma, one block of 384 threads per SM. A work item is one
// band of kRows = 4 full-resolution rows of one image, walked in segments of
// 64 columns.
//   - Weights: the wrapper packs conv_1's kernel (pack_weights in
//     kernels/s2d_region.py) into wgmma's no-swizzle K-major core-matrix
//     order, K = 9*CP rows tap-major, N = CP columns (C padded to 16 with
//     zeros). One thread brings it into shared memory with one
//     cp.async.bulk; it stays for the block's whole walk (73,728 bytes at
//     C = 64, 18,432 at C = 32).
//   - The producer warpgroup fills a ring guarded by full and empty
//     mbarriers (3 stages at C = 64, 6 at C <= 32). A stage is the segment's
//     (4+2) x 66 halo tile of the NORMALIZED, ACTIVATED input, laid out
//     [channel group of 8][halo row][halo column][8 bf16]: the core matrix
//     of 8 consecutive pixels x 16 bytes is 128 contiguous bytes, and each
//     group plane is padded so that 8 neighbouring threads' 16-byte stores
//     fall in distinct banks. Each thread copies its 16-byte vectors of x
//     into the stage with cp.async (one group per segment) and, kAhead
//     segments later (1 at C = 64, 3 at C <= 32), once they have landed,
//     applies IN1 and LeakyReLU in place with the plain version's roundings:
//     float32 (x - mean) * rstd * scale + bias, rounded to bf16, the
//     activation in bf16 (max(t, t * slope) for 0 <= slope <= 1). Its
//     parameters are loaded once per segment, before the math. Outside the
//     image and for padded channels the tile is zero. fence.proxy.async,
//     then the full barrier.
//   - Two consumer warpgroups run wgmma m64nNk16 (N = CP, float32
//     accumulators). M = 64 is one row segment; consumer c owns rows c and
//     c + 2 of the band. The A operand of tap (ky, kx) is the stage itself at
//     a start address shifted by (ky*66 + kx)*16 bytes (stride byte offset
//     128, leading byte offset one group plane): no im2col copy. 2 rows x 9
//     taps x CP/16 k-steps per segment in one group, B from the resident
//     weights; the stage is released when the group completes.
//   - Epilogue in registers: a thread's accumulator rows are pixels lane/4
//     and lane/4 + 8 of its warp's 16 (same column parity), and its two
//     rows share a parity, so every value it holds belongs to one q. It
//     rounds to bf16, the lanes of a quad exchange words so that each stores
//     16 bytes q-major, and it adds Sigma y and Sigma y^2 of the rounded
//     values per (q, channel) in registers. After each band, lanes are
//     reduced by shuffles in a fixed order and each consumer warp writes its
//     row of partials (4 rows per band, no atomics): the bf16 forward repeats
//     bit for bit.
// At C = 64 setmaxnreg gives the producer 152 registers and the consumers
// 176; the launcher refuses to launch unless the kernel has 168.
// What bounds it (H100 80GB HBM3, 700 W; PERF.md): the producer. The
// kernel takes about as long without its tensor work; a second producer
// warpgroup did not speed it up, and shared memory holds no deeper ring at
// C = 64. Dynamic shared memory 227,768 bytes at C = 64, 172,904 at C = 32.
// nvcc -Xptxas -v (sm_90a, CUDA 12.8): C = 64 168 registers, C = 32 145-146,
// C = 16 120; 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
// (chip_smoke.py phase 1 prints it and fails on any spill).
//
// The float32 conv (s2d_conv_kernel) is the 1e-4 correctness mode and lies
// on no bf16 path: a block owns a strip of 8 rows of one image and walks it
// in 8x16-pixel tiles (normalized input loaded into shared memory, FMA on
// the CUDA cores from resident weights, per-strip partials).
#include "hopper.cuh"
#include "instance_norm.cuh"

namespace unet {
namespace {

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// Offset of channel block q of full-resolution pixel (yy, xx) in the s2d tensor.
__device__ __forceinline__ long long s2d_pixel(long long b, int yy, int xx, int hp, int wp,
                                               int c) {
  const int q = (yy & 1) * 2 + (xx & 1);
  return ((b * hp + (yy >> 1)) * wp + (xx >> 1)) * 4LL * c + q * c;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores.
namespace f32 {

constexpr int kTileH = 8;                 // full-resolution rows of a tile (= a strip)
constexpr int kTileW = 16;                // full-resolution columns of a tile
constexpr int kTilePx = kTileH * kTileW;  // 128 pixels
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kThreads = 256;             // 8 warps
constexpr int kSums = 16;                 // per thread: 8 channels x (sum, sum of squares)

// Shared memory of one block, in bytes, laid out in this order.
template <int CP>
struct Smem {
  static constexpr size_t kWeights = align128(sizeof(float) * 9 * CP * CP);  // [tap][ci][co]
  static constexpr size_t kInput = align128(sizeof(float) * kHaloH * kHaloW * CP);
  static constexpr size_t kReduce = align128(sizeof(float) * kThreads * kSums);
  static constexpr size_t kStats = align128(sizeof(float) * (2 * 4 * CP + 2 * CP));
  static constexpr size_t kTotal = kWeights + kInput + kReduce + kStats;
};

__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

__device__ __forceinline__ void store8(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// IN1 then LeakyReLU, in the plain version's op order.
__device__ __forceinline__ float in1_act(float v, float m, float rs, float sc, float bi,
                                         float slope) {
  float t = __fmul_rn(__fsub_rn(v, m), rs);
  t = __fadd_rn(__fmul_rn(t, sc), bi);
  return t >= 0.f ? t : __fmul_rn(t, slope);
}

// The tile's activated input with its halo: in_s[(r * kHaloW + col) * CP + ci],
// zero outside the image and for ci >= c. Vectors of 8 channels.
template <int CP>
__device__ void load_tile(const float* __restrict__ x, float* in_s, const float* mr_s,
                          const float* sb_s, long long b, int y0, int x0, int hf, int wf, int hp,
                          int wp, int c, float slope) {
  constexpr int kVecs = CP / 8;
  for (int i = threadIdx.x; i < kHaloH * kHaloW * kVecs; i += kThreads) {
    const int px = i / kVecs;
    const int ci0 = (i % kVecs) * 8;
    const int yy = y0 - 1 + px / kHaloW;
    const int xx = x0 - 1 + px % kHaloW;
    float vals[8];
    if (ci0 < c && yy >= 0 && yy < hf && xx >= 0 && xx < wf) {
      const int q = (yy & 1) * 2 + (xx & 1);
      float in[8];
      load8(x + s2d_pixel(b, yy, xx, hp, wp, c) + ci0, in);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int ch = q * c + ci0 + k;
        vals[k] = in1_act(in[k], mr_s[ch], mr_s[4 * CP + ch], sb_s[ci0 + k], sb_s[CP + ci0 + k],
                          slope);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) vals[k] = 0.f;
    }
    store8(in_s + px * CP + ci0, vals);
  }
}

// Thread mapping: thread t takes channel group g = t % ng (8 channels) of the
// pixels p = t / ng + k * (kThreads / ng). kThreads / ng is a multiple of 32,
// so every pixel of a thread has the same row parity (p / 16 moves in steps
// of 2) and column (p % 16): one q.
__device__ __forceinline__ int lane_q(int lane) { return ((lane / kTileW) & 1) * 2 + (lane & 1); }

// Write 8 outputs of pixel (yy, xx) in q-major layout and add them to the
// thread's sums.
__device__ __forceinline__ void emit(float* __restrict__ y, const float* acc, long long b, int yy,
                                     int xx, int hp, int wp, int c, int ci0, float* sums) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    sums[k] += acc[k];
    sums[8 + k] += acc[k] * acc[k];
  }
  store8(y + s2d_pixel(b, yy, xx, hp, wp, c) + ci0, acc);
}

// The thread's pixels (see lane_q) times its 8 output channels.
template <int CP, int PPT>
__device__ __forceinline__ void conv_pixels(const float* in_s, const float* w_s, int lane,
                                            int lanes, int ci_group, float (*acc)[8]) {
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;
  }
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    for (int ci = 0; ci < CP; ++ci) {
      float wv[8];
      load8(w_s + (tap * CP + ci) * CP + ci_group * 8, wv);
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
template <int CP>
__global__ void __launch_bounds__(kThreads)
s2d_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ mean1, const float* __restrict__ rstd1,
                const float* __restrict__ scale1, const float* __restrict__ bias1,
                float* __restrict__ y, float* __restrict__ partials, int hp, int wp, int c,
                float slope) {
  using S = Smem<CP>;
  extern __shared__ __align__(128) unsigned char smem_f32[];
  float* w_s = reinterpret_cast<float*>(smem_f32);
  float* in_s = reinterpret_cast<float*>(smem_f32 + S::kWeights);
  float* red_s = reinterpret_cast<float*>(smem_f32 + S::kWeights + S::kInput);
  // IN1's mean [4CP] and rstd [4CP] of this image by q-major channel
  // (q * c + ci), then scale [CP] and bias [CP].
  float* mr_s = reinterpret_cast<float*>(smem_f32 + S::kWeights + S::kInput + S::kReduce);
  float* sb_s = mr_s + 8 * CP;

  const int strip = blockIdx.x;
  const long long b = blockIdx.y;
  const int hf = 2 * hp, wf = 2 * wp;
  const int c4 = 4 * c;

  // Weights (3, 3, c, c) -> [tap][ci][co], zero-padded to CP x CP.
  for (int i = threadIdx.x; i < 9 * CP * CP; i += kThreads) {
    const int tap = i / (CP * CP), ci = (i / CP) % CP, co = i % CP;
    w_s[i] = (ci < c && co < c) ? w[(tap * c + ci) * c + co] : 0.f;
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

  constexpr int kMaxPpt = CP >= 64 ? 4 : (CP >= 32 ? 2 : 1);
  const int y0 = strip * kTileH;
  for (int x0 = 0; x0 < wf; x0 += kTileW) {
    load_tile<CP>(x, in_s, mr_s, sb_s, b, y0, x0, hf, wf, hp, wp, c, slope);
    __syncthreads();
    float acc[kMaxPpt][8];
    if (lane < kTilePx) {
      conv_pixels<CP, kMaxPpt>(in_s, w_s, lane, lanes, g, acc);
#pragma unroll
      for (int k = 0; k < kMaxPpt; ++k) {
        const int p = lane + k * lanes;
        const int yy = y0 + p / kTileW, xx = x0 + p % kTileW;
        if (p < kTilePx && yy < hf && xx < wf) {
          emit(y, acc[k], b, yy, xx, hp, wp, c, g * 8, sums);
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

template <int CP>
cudaError_t launch(const float* x, const float* w, const float* mean1, const float* rstd1,
                   const float* scale1, const float* bias1, float* y, float* partials,
                   long long b, int hp, int wp, int c, float slope, cudaStream_t stream) {
  constexpr size_t kSmem = Smem<CP>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(s2d_conv_kernel<CP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const int nstrips = (2 * hp + kTileH - 1) / kTileH;
  s2d_conv_kernel<CP><<<dim3(nstrips, static_cast<unsigned>(b)), kThreads, kSmem, stream>>>(
      x, w, mean1, rstd1, scale1, bias1, y, partials, hp, wp, c, slope);
  return cudaGetLastError();
}

cudaError_t conv(const void* x, const void* w, const float* mean1, const float* rstd1,
                 const float* scale1, const float* bias1, void* y, float* partials, long long b,
                 int hp, int wp, int c, float slope, cudaStream_t stream) {
  auto xf = static_cast<const float*>(x);
  auto wf = static_cast<const float*>(w);
  auto yf = static_cast<float*>(y);
  switch (c) {
    case 8:
      return launch<8>(xf, wf, mean1, rstd1, scale1, bias1, yf, partials, b, hp, wp, c, slope,
                       stream);
    case 16:
      return launch<16>(xf, wf, mean1, rstd1, scale1, bias1, yf, partials, b, hp, wp, c, slope,
                        stream);
    case 32:
      return launch<32>(xf, wf, mean1, rstd1, scale1, bias1, yf, partials, b, hp, wp, c, slope,
                        stream);
    case 64:
      return launch<64>(xf, wf, mean1, rstd1, scale1, bias1, yf, partials, b, hp, wp, c, slope,
                        stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma.
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kRows = 4;                  // full-resolution rows of a band (a work item)
constexpr int kSegW = 64;                 // columns of a segment: wgmma's M
constexpr int kHaloRows = kRows + 2;
constexpr int kHaloCols = kSegW + 2;
// One block per SM: two consumer warpgroups, rows c and c + 2 of a band for
// consumer c, then the producer warpgroup.
constexpr int kConsumerThreads = 256;
constexpr int kProducerThreads = 128;
constexpr int kThreads = kConsumerThreads + kProducerThreads;
// Registers per thread at C = 64: the launch gives every thread kLaunchRegs
// (65536 / 384, rounded down to 8); setmaxnreg then moves some from the
// producer to the consumers, whose accumulators and sums would otherwise
// spill.
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 152;
constexpr int kConsumerRegs = 176;
static_assert(kProducerThreads * kProducerRegs + kConsumerThreads * kConsumerRegs <=
              kThreads * kLaunchRegs, "setmaxnreg asks for more registers than the block has");
// Rows of IN2 partials a band writes: one per consumer warp of a warpgroup
// (the two warpgroups fill the two row parities of the same rows).
constexpr int kPartialRows = 4;
constexpr int kCoreBytes = 128;           // a no-swizzle core matrix: 8 rows x 16 bytes

template <int CP>
struct Cfg {
  static constexpr int kG = CP / 8;                     // channel groups of 8
  static constexpr int kT = kProducerThreads / kG;      // producer threads per group
  static constexpr int kV = kSegW / kT;                 // a thread's vectors per halo row
  static constexpr int kKSteps = CP / 16;               // wgmma k-steps per tap
  // A group plane [halo row][halo column][8 bf16], padded so that its size
  // is 128 / kG modulo 128: the 8 threads of a quarter warp (8 / kG pixels x
  // kG groups) store to 8 distinct 16-byte bank slots.
  static constexpr int kPlane =
      static_cast<int>(align128(kHaloRows * kHaloCols * 16)) + kCoreBytes / kG;
  static constexpr int kStage = kG * kPlane;
  static constexpr int kWBytes = 9 * CP * CP * 2;       // packed weights
  // Ring stages, as many as shared memory holds up to 6, and how many
  // segments ahead of its activation the producer copies (the rest of the
  // ring: one stage the consumers multiply, one or more activated and
  // waiting).
  static constexpr int kStages = CP >= 64 ? 3 : 6;
  static constexpr int kAhead = kStages >= 6 ? 3 : 1;
  static constexpr int kStageOff = kWBytes;
  static constexpr int kBarOff = kStageOff + kStages * kStage;
  // Halo rows of main vectors a producer thread loads before it computes
  // (one at C = 64: four vectors, within the producer's 152 registers).
  static constexpr int kBatchRows = kV >= 4 ? 1 : 3;
  static constexpr int kSmem = kBarOff + (2 * kStages + 1) * 8;
  static_assert(kSmem <= 232448, "more shared memory than a block may have");
  static_assert(kV >= 1 && kV * kT == kSegW && kHaloRows * 2 * kG <= kProducerThreads,
                "producer mapping");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// LeakyReLU of two bf16 values in bf16, as the plain version: t where t >= 0,
// else t * slope rounded to bf16 (an fma with -0 rounds the exact product
// once). With 0 <= slope <= 1 (MAX) that is max(t, t * slope): for t >= 0
// the rounded product is at most t, for t < 0 at least t. Otherwise the
// sign bit selects; a zero with its sign bit set then takes the product,
// also a zero.
template <bool MAX>
__device__ __forceinline__ uint32_t lrelu_bf16x2(uint32_t t, uint32_t slope2) {
  uint32_t p;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(p) : "r"(t), "r"(slope2), "r"(0x80008000u));
  if constexpr (MAX) {
    uint32_t r;
    asm("max.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(t), "r"(p));
    return r;
  } else {
    const uint32_t mask = ((t >> 15) & 0x00010001u) * 0xFFFFu;
    return (t & ~mask) | (p & mask);
  }
}

// IN1's parameters of one thread's 8 channels: mean and rstd of one q, and
// the affine.
struct Norm {
  float m[8], rs[8];
};
struct Affine {
  float sc[8], bi[8];
};

__device__ __forceinline__ void load8(float (&v)[8], const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void load_norm(Norm& n, const float* mean1, const float* rstd1,
                                          long long at) {
  load8(n.m, mean1 + at);
  load8(n.rs, rstd1 + at);
}

// IN1 then LeakyReLU of 8 bf16 values with the plain version's roundings:
// (x - mean) * rstd * scale + bias in float32, rounded to bf16, activated in
// bf16.
template <bool MAX>
__device__ __forceinline__ uint4 in1_act8(uint4 v, const Norm& n, const Affine& a,
                                          uint32_t slope2) {
  uint4 out;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t w = word(v, k);
    const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xFFFF0000u);
    const float tl = __fadd_rn(
        __fmul_rn(__fmul_rn(__fsub_rn(lo, n.m[2 * k]), n.rs[2 * k]), a.sc[2 * k]), a.bi[2 * k]);
    const float th = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(hi, n.m[2 * k + 1]),
                                                   n.rs[2 * k + 1]),
                                         a.sc[2 * k + 1]),
                               a.bi[2 * k + 1]);
    word(out, k) = lrelu_bf16x2<MAX>(pack_bf16x2(tl, th), slope2);
  }
  return out;
}

// The image geometry and IN1's inputs, as the producer sees them.
struct Input {
  const bf16* x;
  const float *mean1, *rstd1, *scale1, *bias1;
  int hp, wp, c;
};

// Start the copies of x for segment (b, y0, x0) into the stage at `stage`
// (shared address), one cp.async group. A producer thread's vectors of a
// stage: main vector (hr, j) is channel group g = pt % kG of halo column 1 +
// tp + kT*j (tp = pt / kG) of halo row hr; halo vector (if pt < 12 kG) is
// group pt % kG of halo row (pt / kG) / 2, column 0 or 65. Vectors outside
// the image are not copied.
template <int CP>
__device__ __forceinline__ void copy_segment(const Input& in, uint32_t stage, long long b, int y0,
                                             int x0, int pt) {
  using C = Cfg<CP>;
  const int hf = 2 * in.hp, wf = 2 * in.wp, c = in.c;
  auto copy = [&](int g, int hr, int hc) {
    const int yy = y0 - 1 + hr, xx = x0 - 1 + hc;
    if (8 * g < c && yy >= 0 && yy < hf && xx >= 0 && xx < wf) {
      cp_async16(stage + g * C::kPlane + (hr * kHaloCols + hc) * 16,
                 in.x + s2d_pixel(b, yy, xx, in.hp, in.wp, c) + 8 * g);
    }
  };
  const int g = pt % C::kG, tp = pt / C::kG;
#pragma unroll
  for (int hr = 0; hr < kHaloRows; ++hr)
#pragma unroll
    for (int j = 0; j < C::kV; ++j) copy(g, hr, tp + C::kT * j + 1);
  if (pt < 2 * kHaloRows * C::kG) {
    const int r = pt / C::kG;
    copy(g, r >> 1, (r & 1) ? kHaloCols - 1 : 0);
  }
  cp_async_commit();
}

// Normalize and activate, in place, the vectors this thread copied into the
// stage at `stage` (generic pointer) for segment (b, y0, x0); zero the
// others. Every parameter the thread needs is loaded first, so that their
// loads are in flight together: y0 is even, so a main vector's q is fixed by
// its halo row's parity (known once the loop is unrolled) and the thread's
// column parity (tp, as kT and x0 are even).
template <int CP, bool MAX>
__device__ __forceinline__ void activate_segment(const Input& in, unsigned char* stage,
                                                 long long b, int y0, int x0, int pt,
                                                 uint32_t slope2) {
  using C = Cfg<CP>;
  const int hf = 2 * in.hp, wf = 2 * in.wp, c = in.c;
  const int g = pt % C::kG, tp = pt / C::kG;
  const long long img = b * 4LL * c;
  Affine aff;
  Norm norm[2], hnorm;  // norm[yy & 1] of the main vectors; the halo vector's
  if (8 * g < c) {
    load8(aff.sc, in.scale1 + 8 * g);
    load8(aff.bi, in.bias1 + 8 * g);
    load_norm(norm[0], in.mean1, in.rstd1, img + (tp & 1) * c + 8 * g);
    load_norm(norm[1], in.mean1, in.rstd1, img + (2 + (tp & 1)) * c + 8 * g);
  }
  // The halo vector (see copy_segment): its column's parity is not tp's.
  const int r = pt / C::kG;
  const int hhr = r >> 1, hxx = x0 - 1 + ((r & 1) ? kHaloCols - 1 : 0), hyy = y0 - 1 + hhr;
  const bool halo = pt < 2 * kHaloRows * C::kG && 8 * g < c;
  if (halo) {
    load_norm(hnorm, in.mean1, in.rstd1, img + ((hyy & 1) * 2 + (hxx & 1)) * c + 8 * g);
  }
  // The halo vector first, so that its parameters are dead before the main
  // vectors' loads.
  if (pt < 2 * kHaloRows * C::kG) {
    uint4* p = reinterpret_cast<uint4*>(
        stage + g * C::kPlane + (hhr * kHaloCols + hxx - (x0 - 1)) * 16);
    *p = halo && hyy >= 0 && hyy < hf && hxx >= 0 && hxx < wf
             ? in1_act8<MAX>(*p, hnorm, aff, slope2)
             : make_uint4(0u, 0u, 0u, 0u);
  }
  // Main vectors, kBatchRows halo rows at a time: their shared-memory
  // loads, then the math and the stores. A vector outside the image (its
  // copy never issued) is overwritten with zeros.
  const int col0 = tp + 1;  // halo column of main vector j = 0
  const bool col_group = 8 * g < c;
#pragma unroll
  for (int h0 = 0; h0 < kHaloRows; h0 += C::kBatchRows) {
    uint4 v[C::kBatchRows][C::kV];
#pragma unroll
    for (int i = 0; i < C::kBatchRows; ++i)
#pragma unroll
      for (int j = 0; j < C::kV; ++j)
        v[i][j] = *reinterpret_cast<const uint4*>(
            stage + g * C::kPlane + ((h0 + i) * kHaloCols + col0 + C::kT * j) * 16);
#pragma unroll
    for (int i = 0; i < C::kBatchRows; ++i) {
      const int yy = y0 - 1 + h0 + i;
      const bool row_ok = col_group && yy >= 0 && yy < hf;
#pragma unroll
      for (int j = 0; j < C::kV; ++j) {
        const bool ok = row_ok && x0 + tp + C::kT * j < wf;
        *reinterpret_cast<uint4*>(stage + g * C::kPlane +
                                  ((h0 + i) * kHaloCols + col0 + C::kT * j) * 16) =
            ok ? in1_act8<MAX>(v[i][j], norm[(h0 + i + 1) & 1], aff, slope2)
               : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }
}

// The block's work: items blockIdx.x, blockIdx.x + gridDim.x, ... (item =
// image * nbands + band), each walked in nseg segments of kSegW columns.
struct Walk {
  int nbands, nseg;
  long long nitems;
};

template <int CP, bool MAX>
__device__ void produce(const Input& in, const bf16* __restrict__ w, unsigned char* smem,
                        Walk walk, float slope) {
  using C = Cfg<CP>;
  const int pt = threadIdx.x - kConsumerThreads;
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + C::kBarOff, empty0 = full0 + 8 * C::kStages;
  if (pt == 0) {
    const uint32_t wbar = full0 + 16 * C::kStages;
    mbar_arrive_expect_tx(wbar, C::kWBytes);
    bulk_load(base, w, C::kWBytes, wbar);
  }
  const uint32_t slope2 = pack_bf16x2(slope, slope);
  // Segment n of this block is segment n % nseg of item blockIdx.x + (n /
  // nseg) * gridDim.x, in ring stage n % kStages. Step n starts the copies of
  // segment n (one cp.async group, empty past the end) and activates segment
  // n - kAhead, whose group is then complete: kAhead segments' loads are in
  // flight while the thread activates.
  const long long nseg_total =
      walk.nitems > blockIdx.x
          ? ((walk.nitems - 1 - blockIdx.x) / gridDim.x + 1) * walk.nseg
          : 0;
  for (long long n = 0; n < nseg_total + C::kAhead; ++n) {
    if (n < nseg_total) {
      const int stage = static_cast<int>(n % C::kStages);
      mbar_wait(empty0 + 8 * stage, ((n / C::kStages) & 1) ^ 1);
      const long long item = blockIdx.x + (n / walk.nseg) * gridDim.x;
      copy_segment<CP>(in, base + C::kStageOff + stage * C::kStage, item / walk.nbands,
                       static_cast<int>(item % walk.nbands) * kRows,
                       static_cast<int>(n % walk.nseg) * kSegW, pt);
    } else {
      cp_async_commit();
    }
    const long long m = n - C::kAhead;
    if (m >= 0) {
      cp_async_wait<C::kAhead>();
      const int stage = static_cast<int>(m % C::kStages);
      const long long item = blockIdx.x + (m / walk.nseg) * gridDim.x;
      activate_segment<CP, MAX>(in, smem + C::kStageOff + stage * C::kStage, item / walk.nbands,
                           static_cast<int>(item % walk.nbands) * kRows,
                           static_cast<int>(m % walk.nseg) * kSegW, pt, slope2);
      // The stage was written by this thread; wgmma reads it through the
      // async proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full0 + 8 * stage);
    }
  }
}

// d (64 x N, float32) += A (64 x 16, bf16) * B (16 x N, bf16), both K-major
// in shared memory (descriptors a and b).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b) {
  static_assert(N == 16 || N == 32 || N == 64, "m64n16k16, m64n32k16 or m64n64k16");
  if constexpr (N == 16) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
}

// Add the two bf16 values of `w` (channels i and i + 1 of the thread's sums)
// to Sigma y and Sigma y^2.
__device__ __forceinline__ void add_sums(uint32_t w, float* s1, float* s2, int i) {
  const float lo = __uint_as_float(w << 16), hi = __uint_as_float(w & 0xFFFF0000u);
  s1[i] += lo;
  s2[i] += lo * lo;
  s1[i + 1] += hi;
  s2[i + 1] += hi * hi;
}

template <int CP>
__device__ void consume(bf16* __restrict__ y, float* __restrict__ partials, unsigned char* smem,
                        int hp, int wp, int c, Walk walk) {
  using C = Cfg<CP>;
  constexpr int kR = CP / 2;  // accumulator registers of one row segment
  constexpr int kS = CP / 4;  // a thread's channels: 8j + 2*(lane % 4) + e
  constexpr int kN = kRows / 2;  // rows of a consumer: wgi + 2 * r
  const int wgi = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int hf = 2 * hp, wf = 2 * wp, c4 = 4 * c;
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + C::kBarOff, empty0 = full0 + 8 * C::kStages;
  mbar_wait(full0 + 16 * C::kStages, 0);  // the weights
  int stage = 0;
  uint32_t phase = 0;
  for (long long item = blockIdx.x; item < walk.nitems; item += gridDim.x) {
    const long long b = item / walk.nbands;
    const int y0 = static_cast<int>(item % walk.nbands) * kRows;
    // The band's sums; all of a thread's rows have wgi's parity.
    float s1[kS], s2[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) s1[i] = s2[i] = 0.f;
    for (int s = 0; s < walk.nseg; ++s) {
      const int x0 = s * kSegW;
      float acc[kN][kR];
#pragma unroll
      for (int r = 0; r < kN; ++r)
#pragma unroll
        for (int e = 0; e < kR; ++e) acc[r][e] = 0.f;
      mbar_wait(full0 + 8 * stage, phase);
      // The descriptors of the stage's row wgi and of the weights' first
      // k-step; every other one adds its start address offset (in 16-byte
      // units, within the 14-bit field) to these. Opaque to the compiler, so
      // that it computes each where it is used instead of keeping 72 64-bit
      // descriptors live across the loop.
      uint64_t ad = make_desc(base + C::kStageOff + stage * C::kStage + wgi * kHaloCols * 16,
                              C::kPlane, kCoreBytes);
      uint64_t bd = make_desc(base, CP * 16, kCoreBytes);
      asm volatile("" : "+l"(ad), "+l"(bd));
#pragma unroll
      for (int r = 0; r < kN; ++r) fence_acc(acc[r]);
      wgmma_fence();
      // One wgmma group: rows x 9 taps x kKSteps.
#pragma unroll
      for (int r = 0; r < kN; ++r) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int ky = tap / 3, kx = tap % 3;
#pragma unroll
          for (int kc = 0; kc < C::kKSteps; ++kc) {
            const int a = 2 * kc * C::kPlane +
                          ((2 * r + ky) * kHaloCols + kx) * 16;
            wgmma_ss<CP>(acc[r], ad + a / 16, bd + (tap * C::kKSteps + kc) * CP * 2);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < kN; ++r) fence_acc(acc[r]);
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);  // the stage is read
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }

      // Epilogue. Element e of a row's accumulators is pixel 16*warp + lane/4
      // + 8*((e/2)%2) of the segment, channel 8*(e/4) + 2*(lane%4) + e%2.
#pragma unroll
      for (int r = 0; r < kN; ++r) {
        const int yy = y0 + wgi + 2 * r;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int xx = x0 + 16 * warp + lane / 4 + 8 * h;
          const bool ok = yy < hf && xx < wf;
          bf16* dst = y + (ok ? s2d_pixel(b, yy, xx, hp, wp, c) : 0);
          if constexpr (CP >= 32) {
#pragma unroll
            for (int j4 = 0; j4 < CP / 32; ++j4) {
              uint32_t v[4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int j = 4 * j4 + k;
                v[k] = pack_bf16x2(acc[r][4 * j + 2 * h], acc[r][4 * j + 2 * h + 1]);
                if (ok) add_sums(v[k], s1, s2, 2 * j);
              }
              quad_transpose(v);
              if (ok) {
                *reinterpret_cast<uint4*>(dst + 8 * (4 * j4 + lane % 4)) =
                    make_uint4(v[0], v[1], v[2], v[3]);
              }
            }
          } else {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const uint32_t v = pack_bf16x2(acc[r][4 * j + 2 * h], acc[r][4 * j + 2 * h + 1]);
              if (ok && 8 * j < c) {
                add_sums(v, s1, s2, 2 * j);
                *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * (lane % 4)) = v;
              }
            }
          }
        }
      }
    }

    // The band's sums: lanes that share (lane % 4, (lane / 4) % 2) hold the
    // same q and channels; add them in a fixed order, then lanes 0..7 write
    // this warp's row of partials for q = 2*wgi + (lane / 4) % 2.
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      s1[i] += __shfl_xor_sync(0xFFFFFFFFu, s1[i], 8);
      s2[i] += __shfl_xor_sync(0xFFFFFFFFu, s2[i], 8);
      s1[i] += __shfl_xor_sync(0xFFFFFFFFu, s1[i], 16);
      s2[i] += __shfl_xor_sync(0xFFFFFFFFu, s2[i], 16);
    }
    if (lane < 8) {
      const int q = 2 * wgi + (lane >> 2);
      float* row = partials + (item * kPartialRows + warp) * 2LL * c4 + q * c;
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        const int ch = 8 * (i / 2) + 2 * (lane & 3) + i % 2;
        if (ch < c) {
          row[ch] = s1[i];
          row[c4 + ch] = s2[i];
        }
      }
    }
  }
}

// 1-D grid of at most one block per SM. MAX: 0 <= slope <= 1.
template <int CP, bool MAX>
__global__ void __launch_bounds__(kThreads, 1)
s2d_conv_wgmma_kernel(Input in, const bf16* __restrict__ w, bf16* __restrict__ y,
                      float* __restrict__ partials, Walk walk, float slope) {
  using C = Cfg<CP>;
  extern __shared__ __align__(1024) unsigned char smem[];
  if (threadIdx.x == 0) {
    const uint32_t full0 = smem_u32(smem + C::kBarOff);
    for (int s = 0; s < C::kStages; ++s) {
      // full: the producer's threads; empty: the consumers' 8 warps.
      mbar_init(full0 + 8 * s, kProducerThreads);
      mbar_init(full0 + 8 * (C::kStages + s), kConsumerThreads / 32);
    }
    mbar_init(full0 + 16 * C::kStages, 1);  // the weights' bulk copy
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumerThreads) {
    if constexpr (CP >= 64) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    }
    produce<CP, MAX>(in, w, smem, walk, slope);
  } else {
    if constexpr (CP >= 64) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    }
    consume<CP>(y, partials, smem, in.hp, in.wp, in.c, walk);
  }
}

template <int CP>
cudaError_t launch(const Input& in, const void* w, void* y, float* partials, long long b,
                   float slope, cudaStream_t stream) {
  using C = Cfg<CP>;
  auto kernel = slope >= 0.f && slope <= 1.f ? s2d_conv_wgmma_kernel<CP, true>
                                             : s2d_conv_wgmma_kernel<CP, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  if (CP >= 64) {
    // setmaxnreg's counts assume the block starts with kLaunchRegs a thread;
    // with fewer, the consumers' request could never be met.
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (attr.numRegs != kLaunchRegs) return cudaErrorInvalidKernelImage;
  }
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, C::kSmem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  Walk walk;
  walk.nbands = (2 * in.hp + kRows - 1) / kRows;
  walk.nseg = (2 * in.wp + kSegW - 1) / kSegW;
  walk.nitems = b * walk.nbands;
  const long long slots = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(walk.nitems < slots ? walk.nitems : slots);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(in, static_cast<const bf16*>(w),
                                               static_cast<bf16*>(y), partials, walk, slope);
  return cudaGetLastError();
}

cudaError_t conv(const Input& in, const void* w, void* y, float* partials, long long b,
                 float slope, cudaStream_t stream) {
  switch (in.c) {
    case 8:
    case 16:
      return launch<16>(in, w, y, partials, b, slope, stream);
    case 32:
      return launch<32>(in, w, y, partials, b, slope, stream);
    case 64:
      return launch<64>(in, w, y, partials, b, slope, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace wg

}  // namespace
}  // namespace unet

// x: (B, H', W', 4C) q-major, contiguous, 16-byte aligned, float32 or
// bfloat16 (`dtype`); C in {8, 16, 32, 64}. w: conv_1's kernel in x's dtype,
// bfloat16 packed by kernels/s2d_region.py::pack_weights (9 * CP * CP
// values, CP = max(C, 16)), float32 as (3, 3, C_in, C_out). scale*, bias*:
// (C,) float32. Scratch, float32: partials1 (B, nchunk1, 2, 4C),
// mean1/rstd1/mean2/rstd2 (B, 4C), partials2 (B, nrows2, 2, 4C) with nrows2
// = 4 * ceil(2H' / 4) in bf16 (four rows per band of 4 rows) and ceil(2H' /
// 8) in float32 (one per strip of 8 rows). y_conv (the conv output) and out
// are shaped as x. chunk_px * nchunk1 >= H'W'. With `conv_only` only the
// conv runs, on mean1 and rstd1 as a full call left them (for timing it).
extern "C" int unet_s2d_tail_fwd(const void* x, const void* w, const void* scale1,
                                 const void* bias1, const void* scale2, const void* bias2,
                                 void* y_conv, void* out, void* partials1, void* mean1,
                                 void* rstd1, void* partials2, void* mean2, void* rstd2, int dtype,
                                 long long b, int hp, int wp, int c, int chunk_px, int nchunk1,
                                 int nrows2, float eps, float slope, int conv_only,
                                 void* stream) {
  const long long hw = static_cast<long long>(hp) * wp;
  const int rows2 = dtype == unet::kBFloat16
                        ? unet::wg::kPartialRows * ((2 * hp + unet::wg::kRows - 1) /
                                                    unet::wg::kRows)
                        : (2 * hp + unet::f32::kTileH - 1) / unet::f32::kTileH;
  if (b <= 0 || b > 65535 || hp <= 0 || wp <= 0 || c <= 0 || c % 8 != 0 || chunk_px <= 0 ||
      nchunk1 <= 0 || static_cast<long long>(chunk_px) * nchunk1 < hw || nrows2 != rows2 ||
      (dtype != unet::kBFloat16 && dtype != unet::kFloat32)) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto p1 = static_cast<float*>(partials1);
  auto m1 = static_cast<float*>(mean1);
  auto r1 = static_cast<float*>(rstd1);
  auto p2 = static_cast<float*>(partials2);
  auto m2 = static_cast<float*>(mean2);
  auto r2 = static_cast<float*>(rstd2);
  auto sc1 = static_cast<const float*>(scale1);
  auto bi1 = static_cast<const float*>(bias1);
  const int c4 = 4 * c;
  const float n = static_cast<float>(4 * hw);
  cudaError_t err;
  if (!conv_only) {
    err = unet::in_stats(x, dtype, p1, b, hw, c4, chunk_px, nchunk1, s);
    if (err != cudaSuccess) return err;
    err = unet::in_finalize(p1, m1, r1, b, nchunk1, c4, 4, n, eps, s);
    if (err != cudaSuccess) return err;
  }
  if (dtype == unet::kBFloat16) {
    const unet::wg::Input in{static_cast<const __nv_bfloat16*>(x), m1, r1, sc1, bi1, hp, wp, c};
    err = unet::wg::conv(in, w, y_conv, p2, b, slope, s);
  } else {
    err = unet::f32::conv(x, w, m1, r1, sc1, bi1, y_conv, p2, b, hp, wp, c, slope, s);
  }
  if (err != cudaSuccess || conv_only) return err;
  err = unet::in_finalize(p2, m2, r2, b, nrows2, c4, 4, n, eps, s);
  if (err != cudaSuccess) return err;
  return unet::in_apply(y_conv, out, dtype, m2, r2, static_cast<const float*>(scale2),
                        static_cast<const float*>(bias2), b, hw, c4, 4, slope, s);
}
