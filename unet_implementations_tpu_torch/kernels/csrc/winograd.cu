// K4: Winograd F(2x2, 3x3) convolution on q-major space-to-depth tensors,
// for Hopper (sm_90a).
//
// Replaces unet_implementations_tpu/kernels/winograd.py::_wino_s2d_pallas
// (its _wino_s2d_kernel, and _wino_s2d_kernel_folded when U is folded).
//
// The input x (N, GH, GW, 4*Cin) is the q-major space-to-depth of a dense
// (N, 2GH, 2GW, Cin) map (channel q*Cin + c, q = 2*qy + qx, dense pixel
// (2i+qy, 2j+qx)); the output y (N, GH, GW, 4*Cout) is the same layout of the
// SAME, stride-1 3x3 conv of that map, plus a float32 bias. One s2d pixel
// (i, j) is one 2x2 output tile of F(2,3): its 4x4 input window is dense rows
// 2i-1 .. 2i+2 and columns 2j-1 .. 2j+2, zero outside the image (SAME pad).
//
//   Y = A^T [ U_ab . (B^T d B)_ab ] A,   U = G w G^T (computed outside)
//
// Two layouts of U, one kernel:
//   - unfolded, U (16, Cin, Cout): 16 products M_ab = V_ab @ U[4a+b], and the
//     output transform z[2b+r] = sum_a A^T[r][a] M_ab, y(r,s) = sum_b
//     A^T[s][b] z[2b+r] after the sum over Cin. 4/9 of the direct conv's
//     multiply-adds.
//   - folded, U (8, 3*Cin, Cout): the A^T row combine is folded into U,
//     z[2b+r] = [V_{a0,b} V_{a1,b} V_{a2,b}] @ UF[2b+r] with a = r, r+1,
//     r+2: 24 products of K = Cin, 6/9 of the direct conv's multiply-adds.
//   Both views make U a (kMats * Cin, Cout) matrix whose product m reads
//   rows m*Cin .. m*Cin + Cin.
//
// Design. A block owns kTiles consecutive s2d pixels (flattened over image,
// row and column, so any geometry tiles) and kCob output channels, and walks
// Cin in chunks of kKc channels:
//   1. input transform: each thread reads the 4x4 window of one tile for 2
//      channels straight from device memory (halo reads of neighbouring
//      tiles hit L1/L2), forms B^T d B in float32 and writes the 16 V_ab,
//      rounded once to the dtype, to shared memory. The TPU kernel built
//      them from channel-block selects and unit shifts of a VMEM stripe in
//      the input dtype; here the transform is float32 with one rounding,
//      which is at least as close to the exact conv;
//   2. the chunk of U for the block's channels, coalesced 16-byte loads, to
//      shared memory;
//   3. the products: bf16 on the tensor cores (wmma 16x16x16, float32
//      accumulators), 8 warps on a 2 x 4 grid of 16x16 positions of the
//      kTiles x kCob output, one accumulator per product (unfolded: the 16
//      M_ab; folded: the 8 z) held in registers across the whole Cin loop;
//      float32 on the CUDA cores (FMA, no TF32), a thread owning one tile and
//      8 output channels.
// After the last chunk the output transform combines the accumulators
// element by element (every accumulator fragment has the same element
// layout), adds the float32 bias and rounds once to the dtype; bf16 goes
// through shared memory to 16-byte stores of q-major output blocks.
//
// Bound: the larger of the bytes (one read of x, one write of y) and the
// unfolded products' 2*16*Cin*Cout flops per s2d pixel at the bf16 tensor
// rate; at the UNet's shapes (Cin, Cout 128..1024) the two are within 2x of
// each other. This first kernel has no load pipeline: each chunk loads, then
// multiplies, with one block per SM for its registers, so it is latency
// bound; wgmma with a TMA pipeline is later work.
#include <mma.h>

#include "common.cuh"

namespace unet {
namespace {

constexpr int kTiles = 32;     // s2d pixels of a block: the products' M
constexpr int kCob = 64;       // output channels of a block: N
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxGridY = 65535;
constexpr int kCh = 2;         // channels of one thread's input transform

// Input channels of one chunk: K of each product. float32 takes half, so
// that its shared tiles fit.
template <typename T>
__host__ __device__ constexpr int chunk_of() { return sizeof(T) == 2 ? 32 : 16; }

// Rows of the shared tiles are padded by 16 bytes (bank spread; keeps every
// wmma pointer 32-byte aligned).
template <typename T>
__host__ __device__ constexpr int pad_of() { return 16 / static_cast<int>(sizeof(T)); }

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

template <typename T, bool FOLDED>
struct Smem {
  static constexpr int kKc = chunk_of<T>();
  static constexpr int kLdv = kKc + pad_of<T>();   // V_s[16][kTiles][kLdv]
  static constexpr int kLdu = kCob + pad_of<T>();  // U_s[kMats][kKc][kLdu]
  static constexpr int kLdy = kCob + 4;            // staging (float)[4][kTiles][kLdy]
  static constexpr int kMats = FOLDED ? 24 : 16;
  static constexpr size_t kV = align128(sizeof(T) * 16 * kTiles * kLdv);
  static constexpr size_t kU = align128(sizeof(T) * kMats * kKc * kLdu);
  static constexpr size_t kStage = sizeof(float) * 4 * kTiles * kLdy;
  static constexpr size_t kTotal = kV + kU > kStage ? kV + kU : kStage;
};

// Two consecutive channels as float32, and back in T.
__device__ __forceinline__ void load2(const float* p, float* v) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x;
  v[1] = q.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float* v) {
  const Vec<__nv_bfloat16, 2> q = load_vec<__nv_bfloat16, 2>(p);
  v[0] = __bfloat162float(q.v[0]);
  v[1] = __bfloat162float(q.v[1]);
}

template <typename T>
__device__ __forceinline__ void store2(T* p, const float* v) {
  Vec<T, 2> q;
  q.v[0] = from_f32<T>(v[0]);
  q.v[1] = from_f32<T>(v[1]);
  store_vec<T, 2>(p, q);
}

// Product m of the kernel: the V_ab it reads and the accumulator it adds to.
template <bool FOLDED>
__host__ __device__ constexpr int v_of(int m) {
  // folded: m = 3*(2b + r) + idx reads V_{idx + r, b}.
  return FOLDED ? ((m % 3) + ((m / 3) & 1)) * 4 + (m / 3) / 2 : m;
}
template <bool FOLDED>
__host__ __device__ constexpr int acc_of(int m) { return FOLDED ? m / 3 : m; }

// Stage 1: the 16 V_ab of kTiles tiles for channels [c0, c0 + kKc) into V_s.
template <typename T, int KC, int LDV>
__device__ __forceinline__ void input_transform(const T* __restrict__ x, T* v_s, long long tile0,
                                                long long ntiles, int gh, int gw, int cin,
                                                int c0) {
  constexpr int kGroups = KC / kCh;
  for (int item = threadIdx.x; item < kTiles * kGroups; item += kThreads) {
    const int t = item / kGroups;
    const int ch = (item % kGroups) * kCh;
    const long long p = tile0 + t;
    float d[4][4][kCh];  // [dense row][dense column][channel]
    if (p < ntiles) {
      const int j = static_cast<int>(p % gw);
      const long long ni = p / gw;
      const int i = static_cast<int>(ni % gh);
      const long long n = ni / gh;
#pragma unroll
      for (int dr = 0; dr < 4; ++dr) {
        const int yy = 2 * i - 1 + dr;
#pragma unroll
        for (int dc = 0; dc < 4; ++dc) {
          const int xx = 2 * j - 1 + dc;
          if (yy >= 0 && yy < 2 * gh && xx >= 0 && xx < 2 * gw) {
            const int q = (yy & 1) * 2 + (xx & 1);
            const long long off =
                (((n * gh + (yy >> 1)) * gw + (xx >> 1)) * 4 + q) * static_cast<long long>(cin) +
                c0 + ch;
            load2(x + off, d[dr][dc]);
          } else {
#pragma unroll
            for (int k = 0; k < kCh; ++k) d[dr][dc][k] = 0.f;
          }
        }
      }
    } else {
#pragma unroll
      for (int dr = 0; dr < 4; ++dr)
#pragma unroll
        for (int dc = 0; dc < 4; ++dc)
#pragma unroll
          for (int k = 0; k < kCh; ++k) d[dr][dc][k] = 0.f;
    }
    // B^T along the rows: (d0 - d2, d1 + d2, d2 - d1, d1 - d3), then along
    // the columns the same, per channel.
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float r[4][kCh];  // [column][channel]
#pragma unroll
      for (int dc = 0; dc < 4; ++dc) {
#pragma unroll
        for (int k = 0; k < kCh; ++k) {
          const float d0 = d[0][dc][k], d1 = d[1][dc][k], d2 = d[2][dc][k], d3 = d[3][dc][k];
          r[dc][k] = a == 0 ? d0 - d2 : a == 1 ? d1 + d2 : a == 2 ? d2 - d1 : d1 - d3;
        }
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float v[kCh];
#pragma unroll
        for (int k = 0; k < kCh; ++k) {
          const float c0v = r[0][k], c1v = r[1][k], c2v = r[2][k], c3v = r[3][k];
          v[k] = b == 0 ? c0v - c2v : b == 1 ? c1v + c2v : b == 2 ? c2v - c1v : c1v - c3v;
        }
        store2<T>(v_s + ((a * 4 + b) * kTiles + t) * LDV + ch, v);
      }
    }
  }
}

// Stage 2: rows m*Cin + c0 .. + kKc of U, columns co0 .. + kCob, for every
// product m, into U_s[m][k][col].
template <typename T, int KC, int LDU, int MATS>
__device__ __forceinline__ void load_weights(const T* __restrict__ u, T* u_s, int cin, int cout,
                                             int c0, int co0) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kRowVecs = kCob / kVec;
  for (int i = threadIdx.x; i < MATS * KC * kRowVecs; i += kThreads) {
    const int col = (i % kRowVecs) * kVec;
    const int row = i / kRowVecs;  // m * KC + k
    const int m = row / KC, k = row % KC;
    const long long src = (static_cast<long long>(m) * cin + c0 + k) * cout + co0 + col;
    store_vec<T, kVec>(u_s + row * LDU + col, load_vec<T, kVec>(u + src));
  }
}

// The output transform of one element from the accumulators: unfolded
// z[2b+r] = sum_a A^T[r][a] M_ab (A^T = [[1,1,1,0],[0,1,-1,-1]]), folded z
// as accumulated; then y(r,s) = sum_b A^T[s][b] z[2b+r], q = 2r + s.
template <bool FOLDED>
__device__ __forceinline__ void output_transform(const float* acc, float* y) {
  float z[8];
  if constexpr (FOLDED) {
#pragma unroll
    for (int k = 0; k < 8; ++k) z[k] = acc[k];
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      z[2 * b] = acc[b] + acc[4 + b] + acc[8 + b];
      z[2 * b + 1] = acc[4 + b] - acc[8 + b] - acc[12 + b];
    }
  }
  y[0] = z[0] + z[2] + z[4];
  y[1] = z[2] - z[4] - z[6];
  y[2] = z[1] + z[3] + z[5];
  y[3] = z[3] - z[5] - z[7];
}

// grid (Cout / kCob, tile blocks): block (cb, tb) computes output channels
// [cb*kCob, +kCob) of s2d pixels [tb*kTiles, +kTiles), for tb = blockIdx.y,
// blockIdx.y + gridDim.y, ...
template <typename T, bool FOLDED>
__global__ void __launch_bounds__(kThreads)
winograd_s2d_kernel(const T* __restrict__ x, const T* __restrict__ u,
                    const float* __restrict__ bias, T* __restrict__ y, long long ntiles, int gh,
                    int gw, int cin, int cout) {
  using S = Smem<T, FOLDED>;
  constexpr int kKc = S::kKc;
  constexpr int kMats = S::kMats;
  constexpr int kAcc = FOLDED ? 8 : 16;
  extern __shared__ __align__(128) unsigned char smem[];
  T* v_s = reinterpret_cast<T*>(smem);
  T* u_s = reinterpret_cast<T*>(smem + S::kV);
  float* y_s = reinterpret_cast<float*>(smem);  // after the last chunk

  const int co0 = blockIdx.x * kCob;
  const long long ntb = (ntiles + kTiles - 1) / kTiles;
  for (long long tb = blockIdx.y; tb < ntb; tb += gridDim.y) {
    const long long tile0 = tb * kTiles;
    if constexpr (sizeof(T) == 2) {
      using namespace nvcuda;
      const int warp = threadIdx.x / 32;
      const int mt = warp / 4, nt = warp % 4;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kAcc];
#pragma unroll
      for (int k = 0; k < kAcc; ++k) wmma::fill_fragment(acc[k], 0.f);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      for (int c0 = 0; c0 < cin; c0 += kKc) {
        input_transform<T, kKc, S::kLdv>(x, v_s, tile0, ntiles, gh, gw, cin, c0);
        load_weights<T, kKc, S::kLdu, kMats>(u, u_s, cin, cout, c0, co0);
        __syncthreads();
#pragma unroll
        for (int m = 0; m < kMats; ++m) {
#pragma unroll
          for (int ks = 0; ks < kKc / 16; ++ks) {
            wmma::load_matrix_sync(
                fa, v_s + (v_of<FOLDED>(m) * kTiles + 16 * mt) * S::kLdv + 16 * ks, S::kLdv);
            wmma::load_matrix_sync(fb, u_s + (m * kKc + 16 * ks) * S::kLdu + 16 * nt, S::kLdu);
            wmma::mma_sync(acc[acc_of<FOLDED>(m)], fa, fb, acc[acc_of<FOLDED>(m)]);
          }
        }
        __syncthreads();
      }
      // Output transform in place: accumulators 0..3 become y(q).
#pragma unroll
      for (int e = 0; e < acc[0].num_elements; ++e) {
        float in[kAcc], out[4];
#pragma unroll
        for (int k = 0; k < kAcc; ++k) in[k] = acc[k].x[e];
        output_transform<FOLDED>(in, out);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q].x[e] = out[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wmma::store_matrix_sync(y_s + (q * kTiles + 16 * mt) * S::kLdy + 16 * nt, acc[q], S::kLdy,
                                wmma::mem_row_major);
      }
      __syncthreads();
      // (tile, q, 8 channels) per item: one 16-byte store each.
      for (int item = threadIdx.x; item < kTiles * 4 * (kCob / 8); item += kThreads) {
        const int g = item % (kCob / 8);
        const int q = (item / (kCob / 8)) % 4;
        const int t = item / (4 * (kCob / 8));
        const long long p = tile0 + t;
        if (p >= ntiles) continue;
        const float* src = y_s + (q * kTiles + t) * S::kLdy + 8 * g;
        Vec<T, 8> o;
#pragma unroll
        for (int k = 0; k < 8; ++k) o.v[k] = from_f32<T>(src[k] + bias[co0 + 8 * g + k]);
        store_vec<T, 8>(y + (p * 4 + q) * cout + co0 + 8 * g, o);
      }
      __syncthreads();
    } else {
      // float32: thread (t, g) owns tile t and output channels 8g .. 8g+7.
      const int t = threadIdx.x / 8, g = threadIdx.x % 8;
      float acc[kAcc][8];
#pragma unroll
      for (int k = 0; k < kAcc; ++k)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;
      for (int c0 = 0; c0 < cin; c0 += kKc) {
        input_transform<T, kKc, S::kLdv>(x, v_s, tile0, ntiles, gh, gw, cin, c0);
        load_weights<T, kKc, S::kLdu, kMats>(u, u_s, cin, cout, c0, co0);
        __syncthreads();
#pragma unroll
        for (int m = 0; m < kMats; ++m) {
          const float* vrow = reinterpret_cast<const float*>(v_s) +
                              (v_of<FOLDED>(m) * kTiles + t) * S::kLdv;
          const float* urow = reinterpret_cast<const float*>(u_s) + m * kKc * S::kLdu + 8 * g;
          for (int k = 0; k < kKc; ++k) {
            const float a = vrow[k];
            const float4 w0 = *reinterpret_cast<const float4*>(urow + k * S::kLdu);
            const float4 w1 = *reinterpret_cast<const float4*>(urow + k * S::kLdu + 4);
            const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[acc_of<FOLDED>(m)][j] = fmaf(a, w[j], acc[acc_of<FOLDED>(m)][j]);
          }
        }
        __syncthreads();
      }
      const long long p = tile0 + t;
      if (p < ntiles) {
        float out[4][8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float in[kAcc], o[4];
#pragma unroll
          for (int k = 0; k < kAcc; ++k) in[k] = acc[k][j];
          output_transform<FOLDED>(in, o);
#pragma unroll
          for (int q = 0; q < 4; ++q) out[q][j] = o[q] + bias[co0 + 8 * g + j];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float* dst = reinterpret_cast<float*>(y) + (p * 4 + q) * cout + co0 + 8 * g;
          *reinterpret_cast<float4*>(dst) = make_float4(out[q][0], out[q][1], out[q][2], out[q][3]);
          *reinterpret_cast<float4*>(dst + 4) =
              make_float4(out[q][4], out[q][5], out[q][6], out[q][7]);
        }
      }
    }
  }
}

template <typename T, bool FOLDED>
cudaError_t launch(const void* x, const void* u, const float* bias, void* y, long long ntiles,
                   int gh, int gw, int cin, int cout, cudaStream_t stream) {
  constexpr size_t kSmem = Smem<T, FOLDED>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(winograd_s2d_kernel<T, FOLDED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const long long ntb = (ntiles + kTiles - 1) / kTiles;
  const dim3 grid(cout / kCob, static_cast<unsigned>(ntb < kMaxGridY ? ntb : kMaxGridY));
  winograd_s2d_kernel<T, FOLDED><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(u), bias, static_cast<T*>(y), ntiles, gh,
      gw, cin, cout);
  return cudaGetLastError();
}

}  // namespace
}  // namespace unet

// x: (N, GH, GW, 4*Cin) q-major s2d, contiguous, float32 or bfloat16
// (`dtype`). u: (16, Cin, Cout), or (8, 3*Cin, Cout) with `folded`, in x's
// dtype. bias: (Cout,) float32. y: (N, GH, GW, 4*Cout) in x's dtype. Cin a
// multiple of 32, Cout of 64; x, u and y 16-byte aligned.
extern "C" int unet_winograd_s2d_fwd(const void* x, const void* u, const void* bias, void* y,
                                     int dtype, int folded, long long n, int gh, int gw, int cin,
                                     int cout, void* stream) {
  if (n <= 0 || gh <= 0 || gw <= 0 || cin <= 0 || cin % 32 != 0 || cout <= 0 ||
      cout % unet::kCob != 0 || cout / unet::kCob > 65535) {
    return cudaErrorInvalidValue;
  }
  const long long ntiles = n * gh * gw;
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bias);
  if (dtype == unet::kBFloat16) {
    return folded ? unet::launch<__nv_bfloat16, true>(x, u, b, y, ntiles, gh, gw, cin, cout, s)
                  : unet::launch<__nv_bfloat16, false>(x, u, b, y, ntiles, gh, gw, cin, cout, s);
  }
  if (dtype == unet::kFloat32) {
    return folded ? unet::launch<float, true>(x, u, b, y, ntiles, gh, gw, cin, cout, s)
                  : unet::launch<float, false>(x, u, b, y, ntiles, gh, gw, cin, cout, s);
  }
  return cudaErrorInvalidValue;
}
