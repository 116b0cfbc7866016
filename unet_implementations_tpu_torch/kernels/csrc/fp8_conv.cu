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
// (x read once, y written once, the fp8 kernel), whichever is larger; the
// model's big convs are bound by the operations.
//
// Design, simple first: an implicit GEMM, M = B*Ho*Wo output pixels,
// N = Cout, K = kh*kw*Cin in (ky, kx, ci) order, zero-padded to a multiple
// of 32. A block computes a 128 x 64 tile of y with 8 warps (4 x 2, each
// 32 x 32) on mma.sync m16n8k32 with fp8 operands. For each 32-deep k-step
// every thread loads 16 values of one output pixel's input window from device
// memory (two 16-byte loads where Cin is a multiple of 8, else one value at a
// time: Cin = 3, 12), casts them to fp8 in registers and stores 16 bytes to
// shared memory, so the activation's fp8 copy never reaches device memory;
// threads 0-127 copy the k-step's 64 x 32 bytes of the packed kernel (output
// channels past Cout load zeros, their columns are not stored). Two shared-
// memory stages: the next k-step's loads are in flight while the current one
// multiplies. Shared rows are 48 bytes apart, so the fragment loads of a warp
// hit 32 distinct banks. Each mma starts from zero and its result is added to
// the float32 accumulator on the CUDA cores, so the sum over K is float32's
// and not the tensor cores' own accumulation. Later work: wgmma, TMA and a
// persistent schedule (ROADMAP).
#include <cuda_fp16.h>

#include "common.cuh"

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
