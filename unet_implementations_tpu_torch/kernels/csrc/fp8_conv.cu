// The fp8 convolution of the port's fp8 conv mode (ops/quant.py::qconv,
// UNET_TPU_CONV_FP8), forward only, for Hopper (sm_90a).
//
// Replaces no TPU kernel: unet_implementations_tpu/ops/quant.py::qconv is an
// XLA convolution with fp8 operands, not a Pallas kernel. The card has no
// library call for it: F.conv2d takes no float8 operand, and cuBLASLt's fp8
// GEMM (torch._scaled_mm) refuses e5m2 x e5m2, JAX's default pair.
//
// Function. x (B, H, W, Cin) NHWC in bfloat16 or float16 (T), the canonical
// kernel (Cout, Cin, kh, kw) already cast to T and packed to fp8 by
// unet_fp8_pack_weight, stride 1 or 2, explicit top and left padding (the
// bottom and right padding only set Ho and Wo):
//   y = rnd(rnd(sum_k q(x)_k q(w)_k) [+ residual] [+ bias])
// where q() casts T to e5m2 or e4m3fn as XLA does (round to nearest even; no
// saturation: e5m2 overflows to inf, e4m3fn, which has no inf, to NaN above
// 464; a NaN keeps its sign in e4m3fn and becomes 0x7f in e5m2), the sum is
// float32, rnd() rounds to T, and the residual (the running sum of a split
// conv's segments) and the bias are added in T, in that order, as the JAX
// package's `y + yi` and `y + bias.astype(y.dtype)` do.
//
// Bound: the fp8 multiply-adds at the tensor cores' fp8 rate, or the bytes
// (x read once, y written once, the fp8 kernel), whichever is larger: bytes
// for the full-resolution convs (512^2 and 256^2, 32-128 channels), the
// operations for the 256- and 512-channel ones.
//
// Two kernels, chosen by shape alone in kernels/fp8_conv.py::wgmma_plan:
// fp8_conv_wgmma_kernel takes every call whose Cin and Cout are multiples of
// 32 (26 of the 28 convs of a unet_6stage forward), fp8_conv_kernel the rest
// (the first conv, Cin 3 or 12, and the head, Cout 3 or 12).
//
// fp8_conv_kernel (the general one): an implicit GEMM, M = B*Ho*Wo output
// pixels, N = Cout, K = kh*kw*Cin in (ky, kx, ci) order, zero-padded to a
// multiple of 32. A block computes a 128 x 64 tile of y with 8 warps (4 x 2,
// each 32 x 32) on mma.sync m16n8k32 with fp8 operands. For each 32-deep
// k-step every thread loads 16 values of one output pixel's input window
// from device memory (two 16-byte loads where Cin is a multiple of 8, else
// one value at a time: Cin = 3, 12), casts them to fp8 in registers and
// stores 16 bytes to shared memory; threads 0-127 copy the k-step's 64 x 32
// bytes of the packed kernel (output channels past Cout load zeros, their
// columns are not stored). Two shared-memory stages. Each mma starts from
// zero and its result is added to the float32 accumulator on the CUDA cores.
//
// fp8_conv_wgmma_kernel: a persistent, warp-specialised implicit GEMM on
// wgmma, one block of 384 threads per SM (two consumer warpgroups, one
// producer warpgroup). What it does about the general kernel's costs:
//   - mma.sync, not wgmma: wgmma from shared-memory descriptors, m64nNk16,
//     N = Cout's N-tile (32, 64 or 128: no zero columns at Cout = 32).
//   - A cast per load, per tap: each value of x is cast once per tile. The
//     GEMM's rows are the flat pixels of the image's padded parity planes
//     (wg::Conv), so every tap is a constant offset into one plane: the
//     producer stores an item's window once per 16-channel chunk and the
//     taps' descriptors start at shifted addresses in it (no im2col copy,
//     no per-tap address arithmetic). Rows on the pad columns are computed
//     and dropped; stride 2 splits the window into four parity planes.
//   - Register-staged loads, two stages and a __syncthreads per k-step: the
//     producer's cp.async copies run up to three steps ahead in a raw ring, the
//     weights come by one cp.async.bulk per stage, and a ring of 2-4 stages
//     is guarded by full and empty mbarriers; the consumers keep one stage's
//     wgmma group in flight while they wait for the next.
//   - One 128 x 64 tile a block: each block walks its items (an m-block of
//     128 * tiles flat rows times one N-tile; the N-tiles of an m-block are
//     neighbours, so their windows meet in L2), and the plan sizes the items
//     to shared memory and registers.
// Operands: f16, not fp8. wgmma with fp8 operands sums a k32 instruction's
// products with about 13 bits below the largest (tools/wgmma_precision.py:
// 2^-12 of a 1 kept, 2^-14 lost), which misses chip_smoke.py phase 16 (a)'s
// exact-sum gate at K = 288 (the 512^2 level's convs), and also when each
// instruction is promoted into a float32 sum on the CUDA cores. f16 holds
// every e5m2 and e4m3fn value exactly, so the producer casts each value of
// x to fp8 as XLA does and stores the f16 of that fp8 value; the packed
// weights are the same (pack_weight). f16 wgmma keeps float32's bits (2^-24
// of a 1) within an instruction and accumulates in float32 across them, so
// the sum over K stays in the tensor cores: the products are exact and every
// rounding is float32's, as in the general kernel and the plain version.
// The rate is the f16 tensor rate, half the fp8 one; the kernel is bound by
// its producer and its loads well below either.
#include <cuda_fp16.h>
#include <limits.h>

#include "fp8_wgmma.cuh"
#include "hopper.cuh"

namespace unet {
namespace {

enum Fp8Kind : int { kE5M2 = 0, kE4M3 = 1 };

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr int kRow = 48;  // bytes between shared-memory rows: 32 of data, 16 of padding
constexpr int kMaxCastBlocks = 132 * 8;

__device__ __forceinline__ float f32(__nv_bfloat16 v) { return __bfloat162float(v); }
// __half2float drops a NaN's sign, which XLA's e4m3fn cast keeps: rebuilt here.
__device__ __forceinline__ float f32(__half v) {
  const unsigned h = __half_as_ushort(v);
  return (h & 0x7fffu) > 0x7c00u ? __uint_as_float(((h & 0x8000u) << 16) | 0x7fc00000u)
                                 : __half2float(v);
}

template <typename T>
__device__ __forceinline__ T to_t(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half to_t<__half>(float v) { return __float2half_rn(v); }

// v rounded to T, kept in a float register.
template <typename T>
__device__ __forceinline__ float rnd(float v) { return f32(to_t<T>(v)); }

struct Geometry {
  int h, w, cin, ho, wo, cout, kw, stride, pad_t, pad_l, k, kpad;
  long long m;  // B * Ho * Wo
};

// The byte of v, given `sat`, the hardware's saturating conversion of v
// (round to nearest even, clamped to the largest finite value): the values
// that saturation clamps are set as XLA casts them.
template <int KIND>
__device__ __forceinline__ unsigned fix_byte(float v, unsigned sat) {
  const unsigned sign = (__float_as_uint(v) >> 24) & 0x80u;
  const float a = fabsf(v);
  if (KIND == kE4M3) {
    if (!(a <= 464.0f)) return 0x7fu | sign;  // NaN, or past the midpoint above 448
  } else {
    if (a != a) return 0x7fu;
    if (a >= 61440.0f) return 0x7cu | sign;  // rounds past 57344: inf
  }
  return sat;
}

// Two values as two fp8 bytes, lo in the low byte.
template <int KIND>
__device__ __forceinline__ unsigned cast2(float lo, float hi) {
  unsigned short r;
  if (KIND == kE4M3) {
    asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;\n" : "=h"(r) : "f"(hi), "f"(lo));
  } else {
    asm("cvt.rn.satfinite.e5m2x2.f32 %0, %1, %2;\n" : "=h"(r) : "f"(hi), "f"(lo));
  }
  return fix_byte<KIND>(lo, r & 0xffu) | (fix_byte<KIND>(hi, r >> 8) << 8);
}

template <int KIND>
__device__ __forceinline__ unsigned cast4(float a, float b, float c, float d) {
  return cast2<KIND>(a, b) | (cast2<KIND>(c, d) << 16);
}

template <int KIND>
__device__ __forceinline__ void mma_fp8(float (&d)[4], const unsigned (&a)[4],
                                        const unsigned (&b)[2]) {
  const float z = 0.0f;
  if (KIND == kE4M3) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(z), "f"(z),
          "f"(z), "f"(z));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.f32.e5m2.e5m2.f32 {%0,%1,%2,%3}, "
        "{%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(z), "f"(z),
          "f"(z), "f"(z));
  }
}

__device__ __forceinline__ unsigned lds32(const uint8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// VEC: Cin is a multiple of 8 and x is 16-byte aligned, so each group of 8
// k values is 8 channels of one tap, one 16-byte load.
template <typename T, int KIND, bool VEC>
__global__ void __launch_bounds__(kThreads)
    fp8_conv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ wq,
                    const T* __restrict__ bias, const T* __restrict__ residual,
                    T* __restrict__ y, Geometry g) {
  __shared__ __align__(16) uint8_t sa[2][kBM * kRow];
  __shared__ __align__(16) uint8_t sb[2][kBN * kRow];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // A: this thread's output pixel (row of the tile) and 16 of the 32 k values.
  const int a_row = tid >> 1, a_off = (tid & 1) * 16;
  const long long am = m0 + a_row;
  const bool a_ok = am < g.m;
  int iy0 = 0, ix0 = 0;
  const T* xb = x;
  if (a_ok) {
    const int ox = static_cast<int>(am % g.wo);
    const long long t = am / g.wo;
    const int oy = static_cast<int>(t % g.ho);
    iy0 = oy * g.stride - g.pad_t;
    ix0 = ox * g.stride - g.pad_l;
    xb = x + (t / g.ho) * g.h * g.w * g.cin;
  }
  // B: threads 0-127, one output channel and 16 bytes of the k-step.
  const bool b_load = tid < 2 * kBN;
  const int b_row = (tid >> 1) & (kBN - 1), b_off = (tid & 1) * 16;
  const bool b_ok = n0 + b_row < g.cout;
  const uint8_t* wb = wq + static_cast<long long>(b_ok ? n0 + b_row : 0) * g.kpad + b_off;

  // The input position of k (and whether it is inside the image).
  auto source = [&](int k, long long& off) -> bool {
    if (!a_ok || k >= g.k) return false;
    const int tap = k / g.cin, ci = k - tap * g.cin;
    const int ky = tap / g.kw, kx = tap - ky * g.kw;
    const int iy = iy0 + ky, ix = ix0 + kx;
    if (iy < 0 || iy >= g.h || ix < 0 || ix >= g.w) return false;
    off = (static_cast<long long>(iy) * g.w + ix) * g.cin + ci;
    return true;
  };

  Vec<T, 8> av[2];
  bool aok[2] = {false, false};
  unsigned aq[4] = {0u, 0u, 0u, 0u};
  uint4 bv = make_uint4(0u, 0u, 0u, 0u);

  auto load = [&](int kk) {
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        long long off = 0;
        aok[j] = source(kk + a_off + 8 * j, off);
        if (aok[j]) av[j] = load_vec<T, 8>(xb + off);
      }
    } else {
      float f[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        long long off = 0;
        f[j] = source(kk + a_off + j, off) ? f32(xb[off]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        aq[i] = cast4<KIND>(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
      }
    }
    if (b_load) bv = b_ok ? *reinterpret_cast<const uint4*>(wb + kk) : make_uint4(0u, 0u, 0u, 0u);
  };

  auto store = [&](int buf) {
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const T* v = av[j].v + 4 * i;
          aq[2 * j + i] = aok[j] ? cast4<KIND>(f32(v[0]), f32(v[1]), f32(v[2]), f32(v[3])) : 0u;
        }
      }
    }
    *reinterpret_cast<uint4*>(&sa[buf][a_row * kRow + a_off]) =
        make_uint4(aq[0], aq[1], aq[2], aq[3]);
    if (b_load) *reinterpret_cast<uint4*>(&sb[buf][b_row * kRow + b_off]) = bv;
  };

  const int wm = warp & 3, wn = warp >> 2;
  const int gq = lane >> 2, tq = lane & 3;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.0f;

  auto compute = [&](int buf) {
    unsigned a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const uint8_t* p = &sa[buf][(wm * 32 + mi * 16 + gq) * kRow + tq * 4];
      a[mi][0] = lds32(p);
      a[mi][1] = lds32(p + 8 * kRow);
      a[mi][2] = lds32(p + 16);
      a[mi][3] = lds32(p + 8 * kRow + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint8_t* p = &sb[buf][(wn * 32 + ni * 8 + gq) * kRow + tq * 4];
      b[ni][0] = lds32(p);
      b[ni][1] = lds32(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        float d[4];
        mma_fp8<KIND>(d, a[mi], b[ni]);
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = __fadd_rn(acc[mi][ni][r], d[r]);
      }
    }
  };

  const int nk = g.kpad / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * kBK);
    compute(buf);
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  // Epilogue: accumulator element (mi, ni, 2*hf + e) is output pixel
  // wm*32 + mi*16 + gq + 8*hf and channel wn*32 + ni*8 + 2*tq + e.
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long long m = m0 + wm * 32 + mi * 16 + gq + 8 * hf;
      if (m >= g.m) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + ni * 8 + 2 * tq + e;
          if (n >= g.cout) continue;
          const long long idx = m * g.cout + n;
          float v = rnd<T>(acc[mi][ni][2 * hf + e]);
          if (residual != nullptr) v = rnd<T>(__fadd_rn(f32(residual[idx]), v));
          if (bias != nullptr) v = rnd<T>(__fadd_rn(v, f32(bias[n])));
          y[idx] = to_t<T>(v);
        }
      }
    }
  }
}

// The canonical kernel w (Cout, Cin, kh, kw) in T -> fp8 (Cout, kpad), k in
// (ky, kx, ci) order, zeros past kh*kw*Cin.
template <typename T, int KIND>
__global__ void fp8_pack_kernel(const T* __restrict__ w, uint8_t* __restrict__ wq, int cout,
                                int cin, int kh, int kw, int kpad) {
  const int k = kh * kw * cin;
  const long long n = static_cast<long long>(cout) * kpad;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int co = static_cast<int>(i / kpad), kk = static_cast<int>(i % kpad);
    unsigned v = 0u;
    if (kk < k) {
      const int tap = kk / cin, ci = kk - tap * cin;
      const int ky = tap / kw, kx = tap - ky * kw;
      v = cast2<KIND>(f32(w[((static_cast<long long>(co) * cin + ci) * kh + ky) * kw + kx]),
                      0.0f) & 0xffu;
    }
    wq[i] = static_cast<uint8_t>(v);
  }
}

// Elementwise cast (the conv's own cast), for the checks against the plain version.
template <typename T, int KIND>
__global__ void fp8_cast_kernel(const T* __restrict__ x, uint8_t* __restrict__ q, long long n) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    q[i] = static_cast<uint8_t>(cast2<KIND>(f32(x[i]), 0.0f) & 0xffu);
  }
}

template <typename T, int KIND>
int conv(const void* x, const void* wq, const void* bias, const void* residual, void* y,
                 const Geometry& g, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((g.m + kBM - 1) / kBM), (g.cout + kBN - 1) / kBN);
  const bool vec = g.cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                          static_cast<const uint8_t*>(wq),
                                          static_cast<const T*>(bias),
                                          static_cast<const T*>(residual), static_cast<T*>(y), g);
  };
  if (vec) {
    args(fp8_conv_kernel<T, KIND, true>);
  } else {
    args(fp8_conv_kernel<T, KIND, false>);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KIND>
int pack(const void* w, void* wq, int cout, int cin, int kh, int kw, int kpad,
         cudaStream_t stream) {
  const int blocks = grid_for(static_cast<long long>(cout) * kpad, 256, kMaxCastBlocks);
  fp8_pack_kernel<T, KIND><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(w), static_cast<uint8_t*>(wq), cout, cin, kh, kw, kpad);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KIND>
int cast(const void* x, void* q, long long n, cudaStream_t stream) {
  const int blocks = grid_for(n, 256, kMaxCastBlocks);
  fp8_cast_kernel<T, KIND><<<blocks, 256, 0, stream>>>(static_cast<const T*>(x),
                                                       static_cast<uint8_t*>(q), n);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp8_conv_wgmma_kernel: the calls whose Cin and Cout are multiples of 32.
namespace wg {

constexpr int kConsumerThreads = 256;  // warpgroups 0 and 1
constexpr int kProducerThreads = 128;  // warpgroup 2
constexpr int kThreads = kConsumerThreads + kProducerThreads;
// Registers per thread: the launch gives every thread kLaunchRegs (65536 /
// 384, rounded down to 8); setmaxnreg moves some from the producer to the
// consumers, which hold up to 128 accumulator floats a thread.
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 104;
constexpr int kConsumerRegs = 192;
static_assert(kProducerThreads * kProducerRegs + kConsumerThreads * kConsumerRegs <=
              kThreads * kLaunchRegs, "setmaxnreg asks for more registers than the block has");
constexpr int kChunk = 16;       // input channels of a stage: one k16 step of every tap
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;
constexpr int kCoreBytes = 128;  // a no-swizzle core matrix: 8 rows x 16 bytes
// The producer's steps: kSub rows of 64 pixels of one plane (a thread's kSub
// vectors, independent of each other); a raw ring slot holds one step's 16
// channels of T.
constexpr int kSub = 8;
constexpr int kStepPixels = 64 * kSub;
constexpr int kUnitBytes = 64 * kChunk * 2;
constexpr int kStepBytes = kSub * kUnitBytes;
// A wait this long can only be a fault: trap, so the launch fails instead of
// holding the card.
constexpr unsigned long long kMaxWaitNs = 10ull * 1000 * 1000 * 1000;

// n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1, set on the host).
struct FastDiv {
  uint32_t d, mul, shift;
  void set(uint32_t divisor) {
    d = divisor;
    uint32_t log2 = 0;
    while ((1ull << log2) < divisor) ++log2;
    const uint32_t p = 31 + log2;
    mul = static_cast<uint32_t>(((1ull << p) + divisor - 1) / divisor);
    shift = p - 32;
  }
  __device__ __forceinline__ int operator()(int n) const {
    return d == 1 ? n : static_cast<int>(__umulhi(static_cast<uint32_t>(n), mul) >> shift);
  }
};

// The call and its plan (kernels/fp8_conv.py::wgmma_plan). Each image is
// seen as sy * sx parity planes (one at stride 1) of hq x wq pixels, plane
// (py, px) pixel (a, c) being input pixel (a*stride + py - pad_t, c*stride +
// px - pad_l), zero outside the image; output pixel (oy, ox) of image b is
// flat row m = (b*hq + oy)*wq + ox of the GEMM, and tap (ky, kx) reads plane
// (ky % stride, kx % stride) at flat pixel m + (ky / stride)*wq + kx /
// stride. Rows with oy >= ho or ox >= wo are computed and dropped. An item's
// window in plane p is its bm flat rows plus that plane's largest tap
// offset: wp[p] pixels, stored from byte base[p] of the stage's activations.
struct Conv {
  const void* x;
  const uint16_t* wq;
  const void* bias;
  const void* residual;
  void* y;
  int b, h, w, cin, ho, wo, cout, kh, kw, stride, pad_t, pad_l;
  int sy, sx, wq_, hwq;
  FastDiv div_hwq, div_wq;
  int mtotal;       // b * hwq
  int tiles;        // m-tiles of 64 rows a consumer takes per item
  int bm;           // 128 * tiles: flat rows of an item
  int wp[4];        // window pixels of each plane: bm + its largest tap offset, to 8
  int rows[4];      // producer steps of each plane
  int base[4];      // byte offset of each plane in a stage's activations
  int nchunk;       // cin / kChunk
  int ntile;        // cout / BN
  int stages;
  int ring;         // raw ring slots of kStepBytes: 2 or 4
  int wbytes;       // packed weights of one (N-tile, chunk): taps * 16 * BN f16
  int stage_bytes;  // wbytes + the planes' 2 * wp[p] * 16
  long long nitems;
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// mbar_wait, trapping after kMaxWaitNs.
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  unsigned long long start = 0;
  for (int n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == 0) {
      start = global_ns();
    } else if (global_ns() - start > kMaxWaitNs) {
      __trap();
    }
  }
}

// Magnitude bits (sign cleared) of a 16-bit value at or below which the
// fp8 cast is the hardware's saturating conversion unchanged: 448 for
// e4m3fn, 57344 for e5m2, in T. Larger values, infs and NaNs take cast2.
template <typename T, int KIND>
struct FastLimit;
template <>
struct FastLimit<__nv_bfloat16, kE4M3> { static constexpr uint32_t v = 0x43E0u; };
template <>
struct FastLimit<__nv_bfloat16, kE5M2> { static constexpr uint32_t v = 0x4760u; };
template <>
struct FastLimit<__half, kE4M3> { static constexpr uint32_t v = 0x5F00u; };
template <>
struct FastLimit<__half, kE5M2> { static constexpr uint32_t v = 0x7B00u; };

// The two values of a word of T (lo in the low half) as floats.
__device__ __forceinline__ float2 unpack2(uint32_t w, __nv_bfloat16) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
}
__device__ __forceinline__ float2 unpack2(uint32_t w, __half) {
  return make_float2(f32(__ushort_as_half(static_cast<unsigned short>(w & 0xFFFFu))),
                     f32(__ushort_as_half(static_cast<unsigned short>(w >> 16))));
}

// Two floats rounded to T, lo in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __nv_bfloat16) {
  return pack_bf16x2(lo, hi);
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi, __half) {
  uint32_t r;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// An fp8 byte as the f16 of the same value (exact: f16 holds every e5m2 and
// e4m3fn value), a NaN as f16 NaN 0x7e00 with its sign.
template <int KIND>
__device__ __forceinline__ uint32_t widen(uint32_t byte) {
  const uint32_t sign = (byte & 0x80u) << 8;
  if (KIND == kE5M2) {
    return (byte & 0x7Fu) > 0x7Cu ? sign | 0x7E00u : byte << 8;  // e5m2 is f16's top byte
  }
  if ((byte & 0x7Fu) == 0x7Fu) return sign | 0x7E00u;
  uint32_t r;
  asm("{\n"
      ".reg .b16 lo;\n"
      "cvt.u16.u32 lo, %1;\n"
      "cvt.rn.f16x2.e4m3x2 %0, lo;\n"
      "}\n"
      : "=r"(r)
      : "r"(byte));
  return r & 0xFFFFu;
}

// Two fp8 bytes (lo in the low byte), neither a NaN, as an f16x2 word.
template <int KIND>
__device__ __forceinline__ uint32_t widen2(uint32_t bytes) {
  if (KIND == kE5M2) return __byte_perm(bytes, 0u, 0x1404);  // bytes 0, 1 -> top bytes
  uint32_t r;
  asm("{\n"
      ".reg .b16 lo;\n"
      "cvt.u16.u32 lo, %1;\n"
      "cvt.rn.f16x2.e4m3x2 %0, lo;\n"
      "}\n"
      : "=r"(r)
      : "r"(bytes));
  return r;
}

// Whether the fp8 casts of these 8 values of T (a 16-byte vector) are the
// hardware's saturating conversions unchanged: every magnitude is at most
// FastLimit (no NaN, no inf, nothing that XLA's cast rounds past the range).
template <typename T, int KIND>
__device__ __forceinline__ bool fast8(const uint4& v) {
  const uint32_t mag = __vmaxu2(__vmaxu2(v.x & 0x7FFF7FFFu, v.y & 0x7FFF7FFFu),
                                __vmaxu2(v.z & 0x7FFF7FFFu, v.w & 0x7FFF7FFFu));
  const uint32_t lim = FastLimit<T, KIND>::v;
  return (mag & 0xFFFFu) <= lim && (mag >> 16) <= lim;
}

// 8 values of T as the f16 of their fp8 casts: with FAST (fast8 holds) the
// saturating conversion, else cast2, XLA's cast.
template <typename T, int KIND, bool FAST>
__device__ __forceinline__ uint4 cast8(const uint4& v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = unpack2(w[k], T());
    if (FAST) {
      unsigned short r;
      if (KIND == kE4M3) {
        asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;\n" : "=h"(r) : "f"(f.y), "f"(f.x));
      } else {
        asm("cvt.rn.satfinite.e5m2x2.f32 %0, %1, %2;\n" : "=h"(r) : "f"(f.y), "f"(f.x));
      }
      out[k] = widen2<KIND>(r);
    } else {
      const uint32_t b = cast2<KIND>(f.x, f.y);
      out[k] = widen<KIND>(b & 0xFFu) | (widen<KIND>(b >> 8) << 16);
    }
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// The producer's copies: 16 bytes of x into shared memory (zeros where
// src_bytes is 0), one group per unit; a thread waits for its own groups.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most `ahead` (ring - 1: 1 or 3) groups are pending.
__device__ __forceinline__ void cp_async_wait_ahead(int ahead) {
  if (ahead == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  }
}

// Where the producer is in its walk: step (plane, row) of chunk cc of the
// item whose flat rows start at g0 (N-tile nt). Items are blockIdx.x,
// blockIdx.x + gridDim.x, ...; item = m-block * ntile + N-tile, so the
// N-tiles of one m-block are neighbours and their windows meet in L2.
struct Cursor {
  int plane, row, cc, g0, nt;
  long long item;
  __device__ __forceinline__ void start(const Conv& g) {
    plane = row = cc = 0;
    item = blockIdx.x;
    g0 = static_cast<int>(item / g.ntile) * g.bm;
    nt = static_cast<int>(item % g.ntile);
  }
  // Returns whether the step was the last of its stage.
  __device__ __forceinline__ bool next(const Conv& g, int planes) {
    if (++row < g.rows[plane]) return false;
    row = 0;
    if (++plane < planes) return false;
    plane = 0;
    if (++cc == g.nchunk) {
      cc = 0;
      item += gridDim.x;
      g0 = static_cast<int>(item / g.ntile) * g.bm;
      nt = static_cast<int>(item % g.ntile);
    }
    return true;
  }
};

// The producer warpgroup. A stage is the planes' rows[p] steps: a step is
// window pixels [kStepPixels * row, + kStepPixels) of one plane. A thread
// takes, in each step, pixels pix + 64u (u < kSub; pix = 16 * warp + lane %
// 16) of its channel group (lane / 16: 8 of the chunk's 16 channels): it
// copies their 16-byte vectors into its own bytes of a raw ring slot
// (cp.async, zero-filled outside the image) and, `ahead` steps later, once
// they have landed, casts them to fp8 and stores their f16 values in the
// stage: window pixel i of plane p, group grp at base[p] + (grp * wp[p] + i)
// * 16, so a quarter warp stores 128 contiguous bytes. The kSub vectors of a
// step are independent, so their address arithmetic, loads and casts
// overlap: with one producer warp per SM sub-partition, the producer's
// throughput is its instruction-level parallelism. The first step of a
// stage waits for its slot to be empty and brings the stage's weights with
// one bulk copy (thread 0); the last one fences and arrives on the slot's
// full barrier.
template <typename T, int KIND>
__device__ void produce(const Conv& g, unsigned char* smem) {
  const int pt = threadIdx.x - kConsumerThreads;
  const int lane = pt & 31, warp = pt >> 5;
  const int grp = lane >> 4, pix = warp * 16 + (lane & 15);
  const uint32_t base = smem_u32(smem);
  const uint32_t ring0 = base + g.stages * g.stage_bytes;
  const uint32_t full0 = ring0 + g.ring * kStepBytes, empty0 = full0 + 8 * g.stages;
  const unsigned char* raw0 = smem + g.stages * g.stage_bytes + pt * 16;
  const T* x = static_cast<const T*>(g.x);
  const int planes = g.sy * g.sx, ahead = g.ring - 1;
  int steps = 0;  // a stage's
  for (int p = 0; p < planes; ++p) steps += g.rows[p];
  const long long items = (g.nitems - 1 - blockIdx.x) / gridDim.x + 1;
  const long long total = items * g.nchunk * steps;
  Cursor in, out;
  in.start(g);
  out.start(g);
  int ring_in = 0, ring_out = 0, slot = 0;
  uint32_t phase = 0;
  for (long long n = 0; n < total + ahead; ++n) {
    if (n < total) {
      const int py = in.plane / g.sx, px = in.plane - py * g.sx, wp = g.wp[in.plane];
      const uint32_t dst0 = ring0 + ring_in * kStepBytes + pt * 16;
      // Every sub-row copies (zeros past the window or outside the image),
      // so the kSub address computations and copies run without branches.
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const int i = in.row * kStepPixels + 64 * u + pix;
        const int q = in.g0 + i;
        const int bb = g.div_hwq(q);
        const int r = q - bb * g.hwq;
        const int a = g.div_wq(r);
        const int iy = a * g.stride + py - g.pad_t;
        const int ix = (r - a * g.wq_) * g.stride + px - g.pad_l;
        const bool ok = i < wp && q < g.mtotal && iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
        const T* src = x + (ok ? ((static_cast<long long>(bb) * g.h + iy) * g.w + ix) * g.cin +
                                     kChunk * in.cc + 8 * grp
                               : 0);
        cp_async16(dst0 + u * kUnitBytes, src, ok ? 16u : 0u);
      }
      in.next(g, planes);
      if (++ring_in == g.ring) ring_in = 0;
    }
    cp_async_commit();
    if (n < ahead) continue;
    // Step n - ahead has landed (this thread's copies).
    cp_async_wait_ahead(ahead);
    if (out.plane == 0 && out.row == 0) {
      wait_parity(empty0 + 8 * slot, phase ^ 1u);
      if (pt == 0) {
        mbar_arrive_expect_tx(full0 + 8 * slot, g.wbytes);
        bulk_load(base + slot * g.stage_bytes,
                  reinterpret_cast<const unsigned char*>(g.wq) +
                      (static_cast<long long>(out.nt) * g.nchunk + out.cc) * g.wbytes,
                  g.wbytes, full0 + 8 * slot);
      }
    }
    const int wp = g.wp[out.plane];
    unsigned char* dst =
        smem + slot * g.stage_bytes + g.wbytes + g.base[out.plane] + grp * wp * 16;
    const unsigned char* raw = raw0 + ring_out * kStepBytes;
    uint4 v[kSub];
    bool fast = true;
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      v[u] = *reinterpret_cast<const uint4*>(raw + u * kUnitBytes);
      fast = fast && fast8<T, KIND>(v[u]);
    }
    // One test for the step, so that its kSub casts run as one straight line.
    if (fast) {
#pragma unroll
      for (int u = 0; u < kSub; ++u) v[u] = cast8<T, KIND, true>(v[u]);
    } else {
#pragma unroll
      for (int u = 0; u < kSub; ++u) v[u] = cast8<T, KIND, false>(v[u]);
    }
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      const int i = out.row * kStepPixels + 64 * u + pix;
      if (i < wp) *reinterpret_cast<uint4*>(dst + i * 16) = v[u];
    }
    if (out.next(g, planes)) {
      // Written by this thread through the generic proxy, read by wgmma
      // through the async proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full0 + 8 * slot);
      if (++slot == g.stages) {
        slot = 0;
        phase ^= 1u;
      }
    }
    if (++ring_out == g.ring) ring_out = 0;
  }
}

// d (64 x BN, float32) += A (64 x 16) * B (16 x BN), f16, from the
// descriptors a and b.
template <int BN>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 32) {
    wgmma_f16::wgmma_n32(d, a, b);
  } else if constexpr (BN == 64) {
    wgmma_f16::wgmma_n64(d, a, b);
  } else {
    static_assert(BN == 128, "N-tiles of 32, 64 or 128");
    wgmma_f16::wgmma_n128(d, a, b);
  }
}

// The epilogue of 8 channels (a 16-byte vector of T rounded from the float32
// sums): + residual, rounded, then + bias, rounded, each in T.
template <typename T>
__device__ __forceinline__ uint4 add_epilogue(uint4 v, const T* __restrict__ res,
                                              const T* __restrict__ bias) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u), bi = make_uint4(0u, 0u, 0u, 0u);
  if (res != nullptr) r = *reinterpret_cast<const uint4*>(res);
  if (bias != nullptr) bi = __ldg(reinterpret_cast<const uint4*>(bias));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 f = unpack2(word(v, k), T());
    if (res != nullptr) {
      const float2 rf = unpack2(word(r, k), T());
      f.x = rnd<T>(__fadd_rn(rf.x, f.x));
      f.y = rnd<T>(__fadd_rn(rf.y, f.y));
    }
    if (bias != nullptr) {
      const float2 bf = unpack2(word(bi, k), T());
      f.x = rnd<T>(__fadd_rn(f.x, bf.x));
      f.y = rnd<T>(__fadd_rn(f.y, bf.y));
    }
    word(v, k) = pack2(f.x, f.y, T());
  }
  return v;
}

// The consumer warpgroups. Consumer c takes m-tiles [c * tiles, (c + 1) *
// tiles) of each item; per stage one wgmma group of taps x tiles
// instructions, accumulating in the tensor cores' float32. The group of
// stage s is awaited after stage s + 1's is issued, and then stage s's slot
// is released, so the tensor cores always have a group queued.
template <typename T, int BN>
__device__ void consume(const Conv& g, unsigned char* smem) {
  constexpr int kT = 256 / BN;  // most m-tiles a consumer takes
  constexpr int kR = BN / 2;    // accumulator floats of one m-tile a thread
  const int wgi = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + g.stages * g.stage_bytes + g.ring * kStepBytes;
  const uint32_t empty0 = full0 + 8 * g.stages;
  const int tiles = g.tiles;
  const T* res = static_cast<const T*>(g.residual);
  const T* bias = static_cast<const T*>(g.bias);
  T* y = static_cast<T*>(g.y);
  int slot = 0;
  uint32_t phase = 0;
  for (long long item = blockIdx.x; item < g.nitems; item += gridDim.x) {
    const int g0 = static_cast<int>(item / g.ntile) * g.bm;
    const int nt = static_cast<int>(item % g.ntile);
    float acc[kT][kR];
#pragma unroll
    for (int t = 0; t < kT; ++t)
#pragma unroll
      for (int e = 0; e < kR; ++e) acc[t][e] = 0.f;
    int prev = -1;
    for (int cc = 0; cc < g.nchunk; ++cc) {
      wait_parity(full0 + 8 * slot, phase);
      __syncwarp();  // converged for wgmma's .aligned instructions
      const uint32_t st = base + slot * g.stage_bytes;
      // B of tap 0 (the k8 halves BN*16 bytes apart, core matrices along N
      // 128); A of this consumer's first m-tile in a plane (the channel
      // groups wp[p]*16 bytes apart, 8-row core matrices 128). A tap adds
      // its start offset, in 16-byte units, to these.
      uint64_t bd = make_desc(st, BN * 16, kCoreBytes);
      asm volatile("" : "+l"(bd));
      const uint32_t act = st + g.wbytes + wgi * tiles * 64 * 16;
#pragma unroll
      for (int t = 0; t < kT; ++t) fence_acc(acc[t]);
      wgmma_fence();
      for (int ky = 0; ky < g.kh; ++ky) {
        for (int kx = 0; kx < g.kw; ++kx) {
          const int plane = (ky % g.stride) * g.sx + kx % g.stride;
          const uint64_t a = make_desc(act + g.base[plane], g.wp[plane] * 16, kCoreBytes) +
                             (ky / g.stride) * g.wq_ + kx / g.stride;
          const uint64_t b = bd + (ky * g.kw + kx) * 2 * BN;
#pragma unroll
          for (int t = 0; t < kT; ++t) {
            if (t < tiles) mma<BN>(acc[t], a + t * 64, b);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's group
      if (prev >= 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);  // its slot is read
      prev = slot;
      if (++slot == g.stages) {
        slot = 0;
        phase ^= 1u;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < kT; ++t) fence_acc(acc[t]);
    if (lane == 0) mbar_arrive(empty0 + 8 * prev);

    // Epilogue. acc[t][4j + 2h + e] is flat row 16*warp + lane/4 + 8h of
    // m-tile t, channel 8j + 2*(lane%4) + e. The lanes of a quad (one row)
    // exchange words so that each stores 8 channels, 16 bytes.
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      if (t >= tiles) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = g0 + 64 * (wgi * tiles + t) + 16 * warp + lane / 4 + 8 * h;
        const int bb = g.div_hwq(m);
        const int r = m - bb * g.hwq;
        const int oy = g.div_wq(r), ox = r - oy * g.wq_;
        const bool ok = m < g.mtotal && oy < g.ho && ox < g.wo;
        const long long at = ((static_cast<long long>(bb) * g.ho + oy) * g.wo + ox) * g.cout +
                             nt * BN;
#pragma unroll
        for (int j4 = 0; j4 < BN / 32; ++j4) {
          uint32_t v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = 4 * j4 + k;
            v[k] = pack2(acc[t][4 * j + 2 * h], acc[t][4 * j + 2 * h + 1], T());
          }
          quad_transpose(v);
          if (ok) {
            const int ch = 8 * (4 * j4 + (lane & 3));
            uint4 out = make_uint4(v[0], v[1], v[2], v[3]);
            if (res != nullptr || bias != nullptr) {
              out = add_epilogue<T>(out, res != nullptr ? res + at + ch : nullptr,
                                    bias != nullptr ? bias + nt * BN + ch : nullptr);
            }
            *reinterpret_cast<uint4*>(y + at + ch) = out;
          }
        }
      }
    }
  }
}

// 1-D grid of at most one block per SM.
template <typename T, int KIND, int BN>
__global__ void __launch_bounds__(kThreads, 1) fp8_conv_wgmma_kernel(const Conv g) {
  extern __shared__ __align__(1024) unsigned char smem[];
  if (threadIdx.x == 0) {
    const uint32_t full0 = smem_u32(smem + g.stages * g.stage_bytes + g.ring * kStepBytes);
    for (int s = 0; s < g.stages; ++s) {
      // full: the producer's 128 threads and its expect_tx arrival (the
      // weights' bulk copy); empty: the consumers' 8 warps.
      mbar_init(full0 + 8 * s, kProducerThreads + 1);
      mbar_init(full0 + 8 * (g.stages + s), kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumerThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    produce<T, KIND>(g, smem);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<T, BN>(g, smem);
  }
}

template <typename T, int KIND, int BN>
int launch(const Conv& g, cudaStream_t stream) {
  auto kernel = fp8_conv_wgmma_kernel<T, KIND, BN>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  // setmaxnreg's counts assume the block starts with kLaunchRegs a thread;
  // with fewer, the consumers' request could never be met.
  if (attr.numRegs != kLaunchRegs) return cudaErrorInvalidKernelImage;
  const int smem = g.stages * (g.stage_bytes + 16) + g.ring * kStepBytes;
  int device = 0, sms = 0, optin = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > optin) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int grid = static_cast<int>(g.nitems < sms ? g.nitems : sms);
  kernel<<<grid, kThreads, smem, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KIND>
int conv(const Conv& g, int bn, cudaStream_t stream) {
  switch (bn) {
    case 32:
      return launch<T, KIND, 32>(g, stream);
    case 64:
      return launch<T, KIND, 64>(g, stream);
    case 128:
      return launch<T, KIND, 128>(g, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The canonical kernel w (Cout, Cin, kh, kw) in T -> the f16 of its fp8
// cast (widen), in the order the stages copy it: [Cout/BN][Cin/16][tap][2]
// [BN/8][8][8], element (nt, cc, tap, k8, n8, nr, kr) being w[nt*BN + 8*n8 +
// nr, 16*cc + 8*k8 + kr, tap / kw, tap % kw] (kernels/fp8_conv.py::
// pack_order).
template <typename T, int KIND>
__global__ void fp8_pack_wgmma_kernel(const T* __restrict__ w, uint16_t* __restrict__ wq,
                                      int cout, int cin, int kh, int kw, int bn) {
  const int taps = kh * kw, nchunk = cin / kChunk, n8s = bn / 8;
  const long long n = static_cast<long long>(cout) * cin * taps;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long r = i;
    const int kr = static_cast<int>(r % 8);
    r /= 8;
    const int nr = static_cast<int>(r % 8);
    r /= 8;
    const int n8 = static_cast<int>(r % n8s);
    r /= n8s;
    const int k8 = static_cast<int>(r % 2);
    r /= 2;
    const int tap = static_cast<int>(r % taps);
    r /= taps;
    const int cc = static_cast<int>(r % nchunk);
    const int nt = static_cast<int>(r / nchunk);
    const int co = nt * bn + 8 * n8 + nr, ci = kChunk * cc + 8 * k8 + kr;
    const T v = w[((static_cast<long long>(co) * cin + ci) * kh + tap / kw) * kw + tap % kw];
    wq[i] = static_cast<uint16_t>(widen<KIND>(cast2<KIND>(f32(v), 0.0f) & 0xFFu));
  }
}

template <typename T, int KIND>
int pack(const void* w, void* wq, int cout, int cin, int kh, int kw, int bn,
         cudaStream_t stream) {
  const int blocks = grid_for(static_cast<long long>(cout) * cin * kh * kw, 256, kMaxCastBlocks);
  fp8_pack_wgmma_kernel<T, KIND><<<blocks, 256, 0, stream>>>(
      static_cast<const T*>(w), static_cast<uint16_t*>(wq), cout, cin, kh, kw, bn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

// FN<T, KIND>(...) for the dtype and fp8 codes of the entry point.
#define UNET_FP8_CASES(FN, ...)                                                         \
  if (dtype == kBFloat16 && fp8 == kE5M2) return FN<__nv_bfloat16, kE5M2>(__VA_ARGS__); \
  if (dtype == kBFloat16 && fp8 == kE4M3) return FN<__nv_bfloat16, kE4M3>(__VA_ARGS__); \
  if (dtype == kFloat16 && fp8 == kE5M2) return FN<__half, kE5M2>(__VA_ARGS__);         \
  if (dtype == kFloat16 && fp8 == kE4M3) return FN<__half, kE4M3>(__VA_ARGS__);         \
  return cudaErrorInvalidValue

}  // namespace
}  // namespace unet

// x: (B, H, W, Cin) contiguous, `dtype` bfloat16 or float16 (common.cuh);
// wq: (Cout, kpad) fp8 from unet_fp8_pack_weight with the same `fp8` (0 e5m2,
// 1 e4m3fn); bias (Cout,) and residual (B, Ho, Wo, Cout) in the same dtype, or
// null; y: (B, Ho, Wo, Cout) contiguous.
extern "C" int unet_fp8_conv_fwd(const void* x, const void* wq, const void* bias,
                                 const void* residual, void* y, int dtype, int fp8, int b, int h,
                                 int w, int cin, int ho, int wo, int cout, int kh, int kw,
                                 int stride, int pad_t, int pad_l, int kpad, void* stream) {
  using namespace unet;
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || ho <= 0 || wo <= 0 || cout <= 0 || kh <= 0 ||
      kw <= 0 || stride <= 0 || kpad % kBK != 0 || kpad < kh * kw * cin) {
    return cudaErrorInvalidValue;
  }
  const Geometry g{h, w, cin, ho, wo, cout, kw, stride, pad_t, pad_l, kh * kw * cin, kpad,
                   static_cast<long long>(b) * ho * wo};
  UNET_FP8_CASES(conv, x, wq, bias, residual, y, g, static_cast<cudaStream_t>(stream));
}

// w: (Cout, Cin, kh, kw) contiguous in `dtype`; wq: (Cout, kpad) bytes.
extern "C" int unet_fp8_pack_weight(const void* w, void* wq, int dtype, int fp8, int cout,
                                    int cin, int kh, int kw, int kpad, void* stream) {
  using namespace unet;
  if (cout <= 0 || cin <= 0 || kh <= 0 || kw <= 0 || kpad < kh * kw * cin) {
    return cudaErrorInvalidValue;
  }
  UNET_FP8_CASES(pack, w, wq, cout, cin, kh, kw, kpad, static_cast<cudaStream_t>(stream));
}

// x: n values in `dtype`; q: n bytes.
extern "C" int unet_fp8_cast(const void* x, void* q, int dtype, int fp8, long long n,
                             void* stream) {
  using namespace unet;
  if (n <= 0) return cudaErrorInvalidValue;
  UNET_FP8_CASES(cast, x, q, n, static_cast<cudaStream_t>(stream));
}

// x, bias, residual and y as unet_fp8_conv_fwd's, each 16-byte aligned, Cin
// a multiple of 16; wq from unet_fp8_pack_weight_wgmma with the same fp8 and
// bn; bn (32, 64, 128) divides Cout; tiles (1 .. 256 / bn), stages (2 .. 4)
// and ring (2 or 4) from kernels/fp8_conv.py::wgmma_plan.
extern "C" int unet_fp8_conv_wgmma_fwd(const void* x, const void* wq, const void* bias,
                                       const void* residual, void* y, int dtype, int fp8, int b,
                                       int h, int w, int cin, int ho, int wo, int cout, int kh,
                                       int kw, int stride, int pad_t, int pad_l, int bn,
                                       int tiles, int stages, int ring, void* stream) {
  using namespace unet;
  if (b <= 0 || h <= 0 || w <= 0 || cin <= 0 || cin % wg::kChunk != 0 || ho <= 0 || wo <= 0 ||
      cout <= 0 || kh <= 0 || kw <= 0 || (stride != 1 && stride != 2) ||
      (bn != 32 && bn != 64 && bn != 128) || cout % bn != 0 || tiles < 1 || tiles > 256 / bn ||
      stages < 2 || stages > wg::kMaxStages ||
      (ring != 2 && ring != 4)) {
    return cudaErrorInvalidValue;
  }
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wq) |
                          reinterpret_cast<uintptr_t>(bias) |
                          reinterpret_cast<uintptr_t>(residual) | reinterpret_cast<uintptr_t>(y);
  if (align % 16 != 0) return cudaErrorMisalignedAddress;
  wg::Conv g{};
  g.x = x;
  g.wq = static_cast<const uint16_t*>(wq);
  g.bias = bias;
  g.residual = residual;
  g.y = y;
  g.b = b, g.h = h, g.w = w, g.cin = cin, g.ho = ho, g.wo = wo, g.cout = cout;
  g.kh = kh, g.kw = kw, g.stride = stride, g.pad_t = pad_t, g.pad_l = pad_l;
  g.sy = kh < stride ? kh : stride;
  g.sx = kw < stride ? kw : stride;
  g.wq_ = wo + (kw - 1) / stride;
  const long long hwq = static_cast<long long>(ho + (kh - 1) / stride) * g.wq_;
  const long long mtotal = b * hwq;
  g.bm = 128 * tiles;
  const long long wp_max =
      (g.bm + static_cast<long long>((kh - 1) / stride) * g.wq_ + (kw - 1) / stride + 7) / 8 * 8;
  // Flat rows and window pixels are ints.
  if (mtotal + g.bm + wp_max >= INT_MAX) return cudaErrorInvalidValue;
  long long act = 0;
  for (int p = 0; p < g.sy * g.sx; ++p) {
    const int py = p / g.sx, px = p % g.sx;
    g.wp[p] = (g.bm + (kh - 1 - py) / stride * g.wq_ + (kw - 1 - px) / stride + 7) / 8 * 8;
    g.rows[p] = (g.wp[p] + wg::kStepPixels - 1) / wg::kStepPixels;
    g.base[p] = static_cast<int>(act);
    act += 2LL * g.wp[p] * 16;
  }
  g.hwq = static_cast<int>(hwq);
  g.div_hwq.set(static_cast<uint32_t>(hwq));
  g.div_wq.set(static_cast<uint32_t>(g.wq_));
  g.mtotal = static_cast<int>(mtotal);
  g.tiles = tiles;
  g.nchunk = cin / wg::kChunk;
  g.ntile = cout / bn;
  g.stages = stages;
  g.ring = ring;
  g.wbytes = kh * kw * wg::kChunk * bn * 2;
  const long long stage = g.wbytes + act;
  if (stages * (stage + 16) + ring * wg::kStepBytes > wg::kSmemLimit) return cudaErrorInvalidValue;
  g.stage_bytes = static_cast<int>(stage);
  g.nitems = (mtotal + g.bm - 1) / g.bm * g.ntile;
  const auto s = static_cast<cudaStream_t>(stream);
  UNET_FP8_CASES(wg::conv, g, bn, s);
}

// w: (Cout, Cin, kh, kw) contiguous in `dtype`, Cin a multiple of 16 and
// Cout of bn; wq: Cout * Cin * kh * kw f16 values in wg::fp8_pack_wgmma_kernel's
// order.
extern "C" int unet_fp8_pack_weight_wgmma(const void* w, void* wq, int dtype, int fp8, int cout,
                                          int cin, int kh, int kw, int bn, void* stream) {
  using namespace unet;
  if (cout <= 0 || cin <= 0 || cin % wg::kChunk != 0 || kh <= 0 || kw <= 0 ||
      (bn != 32 && bn != 64 && bn != 128) || cout % bn != 0) {
    return cudaErrorInvalidValue;
  }
  UNET_FP8_CASES(wg::pack, w, wq, cout, cin, kh, kw, bn, static_cast<cudaStream_t>(stream));
}
