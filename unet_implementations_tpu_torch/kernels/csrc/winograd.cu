// K4: Winograd F(2x2, 3x3) convolution on q-major space-to-depth tensors,
// for Hopper (sm_90a).
//
// Replaces unet_implementations_tpu/kernels/winograd.py::_wino_s2d_pallas
// (winograd.py:365, its pallas_call at :378): _wino_s2d_kernel (:167) and,
// when U is folded, _wino_s2d_kernel_folded (:266).
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
// Two layouts of U:
//   - unfolded, U (16, Cin, Cout): 16 products M_ab = V_ab @ U[4a+b], and the
//     output transform z[2b+r] = sum_a A^T[r][a] M_ab, y(r,s) = sum_b
//     A^T[s][b] z[2b+r] after the sum over Cin. 4/9 of the direct conv's
//     multiply-adds.
//   - folded, U (8, 3*Cin, Cout): the A^T row combine is folded into U,
//     z[2b+r] = [V_{a0,b} V_{a1,b} V_{a2,b}] @ UF[2b+r] with a = r, r+1,
//     r+2: 24 products of K = Cin, 6/9 of the direct conv's multiply-adds.
//   Both views make U kMats (Cin, Cout) matrices: product m reads matrix m
//   (folded: m = 3*(2b+r) + idx, rows idx*Cin .. of UF[2b+r]).
//
// Bound. At the UNet's four eligible convs at b32 the 16 products' 2*16*Cin*
// Cout flops per s2d pixel at the bf16 tensor rate (0.358 ms for the four
// forwards) lie above the bytes (one read of x and U, one write of y).
//
// Ceiling of a fused F(2,3) kernel on this card. A block keeps 16 float32
// accumulators (one per product M_ab) for every (pixel, channel) of its
// M x N output, so the register file allows M*N of about 2.5K, e.g. 64 x 32.
// Per Kc-channel chunk, V (16 M x Kc) and U (16 Kc x N) are each written to
// shared memory once and read once by the tensor cores, about 64*(M+N)*Kc
// bytes against 16*M*N*Kc multiply-adds; at 128 B/clk of shared memory and
// about 2,000 bf16 multiply-adds/clk per SM the tensor cores are busy at
// most M*N/(64*(M+N)), about 1/3, of the time: some 1.1 ms for the four b32
// forwards, against cuDNN's 1.44 ms.
//
// Design, bf16 (winograd_s2d_wgmma_kernel). The input transform and its L2
// reads are repeated for every block of output channels, and at 64 x 32 they
// bound the kernel (PERF.md), so this design spends tensor work, which has
// room, to widen N. Each consumer accumulates the 4 outputs
//   y(r,s) = sum_{a,b} A^T[r][a] A^T[s][b] M_ab
// directly: 4 accumulators per (pixel, channel), so a block is 64 s2d pixels
// (wgmma's M) by 128 output channels, and each V build serves 128. An M_ab
// with 2 or 4 nonzero coefficients is multiplied once per output it feeds:
// 36 wgmmas per consumer and k16 step where the function needs 16.
// One persistent block per SM walks work items (pixel block x column block,
// the column blocks of one pixel range adjacent so that their input
// transforms and halo reads hit L2); 384 threads in three warpgroups,
// specialised, with setmaxnreg moving registers to the consumers:
//   - the producer (warpgroup 2) fills a 2-stage ring in shared memory, one
//     chunk of 16 input channels a stage, guarded by a full and an empty
//     mbarrier per stage. One thread starts a single 1-D cp.async.bulk of the
//     chunk's U, which the wrapper packed (pack_weights) so that one (column
//     block, chunk) is one contiguous run already in wgmma's no-swizzle
//     core-matrix layout (8 rows x 16 bytes; no tensor map, no swizzle). Each
//     of the 128 threads forms B^T d B for one tile and 8 channels from
//     16-byte loads of its 4x4 window (the window's outer columns come from
//     the neighbouring lanes by shuffle), in float32 with one rounding to
//     bf16, and writes the 16 V_ab rows straight into the same layout;
//   - two consumer warpgroups, one per half of the item's channels (64 each,
//     128 accumulator registers), run wgmma m64n64k16 on the stage that has
//     landed and release it when their groups complete: A = V_ab in
//     registers, loaded once per stage with ldmatrix into one of 4 rotating
//     fragments, B = U from shared memory, float32 accumulators, wgmma's
//     scale of A giving the minus signs;
//   - epilogue: the bias is added and y rounded once to bf16 in registers;
//     the 4 lanes of a quad exchange words so that each stores one block of
//     8 channels as one 16-byte q-major store (no staging, so the producer
//     fills the next item's stages meanwhile).
// The folded U (24 matrices, with the A^T row signs) takes the same path at
// 64 channels a block (m64n32k16), as 128 would not leave room for 2 stages.
// Stages: V 32 KiB + U 64 KiB (unfolded) or 48 KiB (folded); dynamic shared
// memory 196,640 / 163,872 bytes. Shared memory bounds the kernel: per
// chunk the consumers read about 208 KiB (each V_ab once, U once per
// product; A from shared memory would make it 288 KiB) beside the 96 KiB
// written. A deeper ring, a cp.async copy of the next window and a U
// multicast across 2-block clusters measured no faster (PERF.md).
// nvcc -Xptxas -v (sm_90a, CUDA 12.8), both modes: 168 registers
// (setmaxnreg: producer 152, consumers 176), 0 bytes stack frame, 0 bytes
// spill stores, 0 bytes spill loads.
//
// float32 (winograd_s2d_f32_kernel) is the 1e-4 correctness mode, on no bf16
// path: CUDA-core FMA, a block of 32 tiles x 64 channels, Cin in chunks of
// 16 loaded then multiplied, a thread owning one tile and 8 channels (230 /
// 128 registers unfolded / folded, no spills).
#include <climits>

#include "hopper.cuh"

namespace unet {
namespace {

// Product m of the kernel: the V_ab it reads and the accumulator it adds to.
template <bool FOLDED>
__host__ __device__ constexpr int v_of(int m) {
  // folded: m = 3*(2b + r) + idx reads V_{idx + r, b}.
  return FOLDED ? ((m % 3) + ((m / 3) & 1)) * 4 + (m / 3) / 2 : m;
}
template <bool FOLDED>
__host__ __device__ constexpr int acc_of(int m) { return FOLDED ? m / 3 : m; }

// The output transform of one element from all accumulators: unfolded
// z[2b+r] = sum_a A^T[r][a] M_ab, folded z as accumulated; then y(r,s) =
// sum_b A^T[s][b] z[2b+r], q = 2r + s (A^T = [[1,1,1,0],[0,1,-1,-1]]).
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

// B^T along one axis of a 4-vector: (d0 - d2, d1 + d2, d2 - d1, d1 - d3).
__device__ __forceinline__ float bt(int a, float d0, float d1, float d2, float d3) {
  return a == 0 ? d0 - d2 : a == 1 ? d1 + d2 : a == 2 ? d2 - d1 : d1 - d3;
}

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// ---------------------------------------------------------------------------
// float32: CUDA cores.
namespace f32 {

constexpr int kTiles = 32;     // s2d pixels of a block
constexpr int kCob = 64;       // output channels of a block
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxGridY = 65535;
constexpr int kKc = 16;        // input channels of a chunk
constexpr int kCh = 2;         // channels of one thread's input transform
constexpr int kLdv = kKc + 4;  // V_s[16][kTiles][kLdv] (rows padded by 16 bytes)
constexpr int kLdu = kCob + 4; // U_s[kMats][kKc][kLdu]

template <bool FOLDED>
struct Smem {
  static constexpr int kMats = FOLDED ? 24 : 16;
  static constexpr size_t kV = align128(sizeof(float) * 16 * kTiles * kLdv);
  static constexpr size_t kU = align128(sizeof(float) * kMats * kKc * kLdu);
  static constexpr size_t kTotal = kV + kU;
};

// The 16 V_ab of kTiles tiles for channels [c0, c0 + kKc) into V_s.
__device__ __forceinline__ void input_transform(const float* __restrict__ x, float* v_s,
                                                long long tile0, long long ntiles, int gh, int gw,
                                                int cin, int c0) {
  constexpr int kGroups = kKc / kCh;
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
            const float2 v = *reinterpret_cast<const float2*>(x + off);
            d[dr][dc][0] = v.x;
            d[dr][dc][1] = v.y;
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
    // B^T along the rows, then along the columns, per channel.
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float r[4][kCh];  // [column][channel]
#pragma unroll
      for (int dc = 0; dc < 4; ++dc)
#pragma unroll
        for (int k = 0; k < kCh; ++k)
          r[dc][k] = bt(a, d[0][dc][k], d[1][dc][k], d[2][dc][k], d[3][dc][k]);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float2 v;
        v.x = bt(b, r[0][0], r[1][0], r[2][0], r[3][0]);
        v.y = bt(b, r[0][1], r[1][1], r[2][1], r[3][1]);
        *reinterpret_cast<float2*>(v_s + ((a * 4 + b) * kTiles + t) * kLdv + ch) = v;
      }
    }
  }
}

// Rows m*Cin + c0 .. + kKc of U, columns co0 .. + kCob, for every product m,
// into U_s[m][k][col].
template <int MATS>
__device__ __forceinline__ void load_weights(const float* __restrict__ u, float* u_s, int cin,
                                             int cout, int c0, int co0) {
  constexpr int kRowVecs = kCob / 4;
  for (int i = threadIdx.x; i < MATS * kKc * kRowVecs; i += kThreads) {
    const int col = (i % kRowVecs) * 4;
    const int row = i / kRowVecs;  // m * kKc + k
    const int m = row / kKc, k = row % kKc;
    const long long src = (static_cast<long long>(m) * cin + c0 + k) * cout + co0 + col;
    *reinterpret_cast<float4*>(u_s + row * kLdu + col) = *reinterpret_cast<const float4*>(u + src);
  }
}

// grid (Cout / kCob, tile blocks): block (cb, tb) computes output channels
// [cb*kCob, +kCob) of s2d pixels [tb*kTiles, +kTiles), for tb = blockIdx.y,
// blockIdx.y + gridDim.y, ...; thread (t, g) owns tile t and channels 8g..8g+7.
template <bool FOLDED>
__global__ void __launch_bounds__(kThreads)
winograd_s2d_f32_kernel(const float* __restrict__ x, const float* __restrict__ u,
                        const float* __restrict__ bias, float* __restrict__ y, long long ntiles,
                        int gh, int gw, int cin, int cout) {
  using S = Smem<FOLDED>;
  constexpr int kMats = S::kMats;
  constexpr int kAcc = FOLDED ? 8 : 16;
  extern __shared__ __align__(128) unsigned char smem_f32[];
  float* v_s = reinterpret_cast<float*>(smem_f32);
  float* u_s = reinterpret_cast<float*>(smem_f32 + S::kV);

  const int co0 = blockIdx.x * kCob;
  const long long ntb = (ntiles + kTiles - 1) / kTiles;
  const int t = threadIdx.x / 8, g = threadIdx.x % 8;
  for (long long tb = blockIdx.y; tb < ntb; tb += gridDim.y) {
    const long long tile0 = tb * kTiles;
    float acc[kAcc][8];
#pragma unroll
    for (int k = 0; k < kAcc; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;
    for (int c0 = 0; c0 < cin; c0 += kKc) {
      input_transform(x, v_s, tile0, ntiles, gh, gw, cin, c0);
      load_weights<kMats>(u, u_s, cin, cout, c0, co0);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kMats; ++m) {
        const float* vrow = v_s + (v_of<FOLDED>(m) * kTiles + t) * kLdv;
        const float* urow = u_s + m * kKc * kLdu + 8 * g;
        for (int k = 0; k < kKc; ++k) {
          const float a = vrow[k];
          const float4 w0 = *reinterpret_cast<const float4*>(urow + k * kLdu);
          const float4 w1 = *reinterpret_cast<const float4*>(urow + k * kLdu + 4);
          const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[acc_of<FOLDED>(m)][j] = fmaf(a, w[j], acc[acc_of<FOLDED>(m)][j]);
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
        float* dst = y + (p * 4 + q) * cout + co0 + 8 * g;
        *reinterpret_cast<float4*>(dst) = make_float4(out[q][0], out[q][1], out[q][2], out[q][3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(out[q][4], out[q][5], out[q][6], out[q][7]);
      }
    }
  }
}

template <bool FOLDED>
cudaError_t launch(const float* x, const float* u, const float* bias, float* y, long long ntiles,
                   int gh, int gw, int cin, int cout, cudaStream_t stream) {
  constexpr size_t kSmem = Smem<FOLDED>::kTotal;
  cudaError_t err = cudaFuncSetAttribute(winograd_s2d_f32_kernel<FOLDED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmem));
  if (err != cudaSuccess) return err;
  const long long ntb = (ntiles + kTiles - 1) / kTiles;
  const dim3 grid(cout / kCob, static_cast<unsigned>(ntb < kMaxGridY ? ntb : kMaxGridY));
  winograd_s2d_f32_kernel<FOLDED>
      <<<grid, kThreads, kSmem, stream>>>(x, u, bias, y, ntiles, gh, gw, cin, cout);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma.
namespace wg {

constexpr int kM = 64;                   // s2d pixels of a work item: wgmma's M
constexpr int kKc = 16;                  // input channels of a ring stage: wgmma's K
constexpr int kStages = 2;
constexpr int kConsumerThreads = 256;    // warpgroups 0 and 1
constexpr int kProducerThreads = 128;    // warpgroup 2
constexpr int kThreads = kConsumerThreads + kProducerThreads;
// Registers per thread: the launch gives every thread kLaunchRegs (65536 /
// 384, rounded down to 8); setmaxnreg then moves them, with nothing left
// over: 128 * kProducerRegs + 256 * kConsumerRegs = 384 * kLaunchRegs.
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 152;
constexpr int kConsumerRegs = 176;
static_assert(kProducerThreads * kProducerRegs + kConsumerThreads * kConsumerRegs <=
              kThreads * kLaunchRegs, "setmaxnreg asks for more registers than the block has");
// No-swizzle core matrices (8 rows x 16 bytes = 8 bf16 of K): a V_ab is
// [Kc/8][kM/8][8][8] and a U matrix [Kc/8][N/8][8][8], so the core matrices
// next in K are kM*16 (V) or N*16 (U) bytes apart (LBO), those next in M or
// N 128 bytes (SBO); consumer c's columns start c*kNc/8 core matrices into U.
constexpr int kCoreBytes = 128;
constexpr int kVLbo = kM * 16;
constexpr int kVMat = kM * kKc * 2;  // bytes of one V_ab
constexpr int kVBytes = 16 * kVMat;

template <bool FOLDED>
struct Cfg {
  // Output channels of a work item: 128 with the 16 U matrices; the folded
  // U's 24 would not leave room for 2 stages, so 64.
  static constexpr int kN = FOLDED ? 64 : 128;
  static constexpr int kNc = kN / 2;              // one consumer's: wgmma's N
  static constexpr int kMats = FOLDED ? 24 : 16;  // U matrices of a chunk
  static constexpr int kULbo = kN * 16;
  static constexpr int kUMat = kN * kKc * 2;      // bytes of one U matrix
  static constexpr int kUBytes = kMats * kUMat;   // one packed (column block, chunk) run
  static constexpr int kStageBytes = kVBytes + kUBytes;
  static constexpr int kBarOffset = kStages * kStageBytes;
  static constexpr int kSmem = kBarOffset + 2 * kStages * 8;
  static_assert(kSmem <= 232448, "more shared memory than a block may have");
};

// This warp's 16 rows (16*warp ..) of a 64 x 16 bf16 matrix in the
// no-swizzle core-matrix layout at `addr`, as wgmma's register A fragment.
__device__ __forceinline__ void load_a(uint32_t (&f)[4], uint32_t addr, int warp, int lane) {
  // Lane l gives row l%8 of core matrix l/8: rows 16*warp + 8*((l/8)%2),
  // k 8*(l/16).
  const uint32_t row = addr + (lane / 16) * kVLbo + (2 * warp + (lane / 8) % 2) * kCoreBytes +
                       (lane % 8) * 16;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(f[0]), "=r"(f[1]), "=r"(f[2]), "=r"(f[3])
               : "r"(row)
               : "memory");
}

// d (64 x N, float32) += SIGN * A (64 x 16, bf16) * B (16 x N, bf16): A from
// registers (load_a), B K-major in shared memory (SIGN is wgmma's scale of
// A, +1 or -1).
template <int N, int SIGN>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[N / 2], const uint32_t (&a)[4],
                                             uint64_t b) {
  static_assert(N == 32 || N == 64, "m64n32k16 or m64n64k16");
  if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, %22, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(SIGN));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, %38, 1, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(SIGN));
  }
}

// Bits of the producer's `valid` word: the tile exists; the window row above
// (dense row 2i-1) and below (2i+2) and the columns left and right lie
// inside the image.
enum : unsigned { kTile = 1, kUp = 2, kDown = 4, kLeft = 8, kRight = 16 };

// A producer thread's item: one tile and 8 channels of it.
struct Window {
  const __nv_bfloat16* src;  // the tile's own s2d pixel at q = 0, the item's channels
  unsigned valid;            // kTile | kUp | kDown | kLeft | kRight
};

__device__ __forceinline__ Window window_of(const __nv_bfloat16* x, long long item, int ncb,
                                            int t, int g, int ntiles, int gh, int gw, int cin) {
  Window w{x, 0u};
  const long long p = item / ncb * kM + t;
  if (p < ntiles) {
    const int pi = static_cast<int>(p);
    const int j = pi % gw, i = (pi / gw) % gh, n = pi / gw / gh;
    w.valid = kTile | (i > 0 ? kUp : 0u) | (i + 1 < gh ? kDown : 0u) | (j > 0 ? kLeft : 0u) |
              (j + 1 < gw ? kRight : 0u);
    w.src = x + ((static_cast<long long>(n) * gh + i) * gw + j) * 4LL * cin + 8 * g;
  }
  return w;
}

// v of the lane below (up) or above.
__device__ __forceinline__ uint4 shfl_lane(uint4 v, bool up) {
  const unsigned all = 0xFFFFFFFFu;
  if (up) {
    return make_uint4(__shfl_up_sync(all, v.x, 1), __shfl_up_sync(all, v.y, 1),
                      __shfl_up_sync(all, v.z, 1), __shfl_up_sync(all, v.w, 1));
  }
  return make_uint4(__shfl_down_sync(all, v.x, 1), __shfl_down_sync(all, v.y, 1),
                    __shfl_down_sync(all, v.z, 1), __shfl_down_sync(all, v.w, 1));
}

// The 4x4 dense window of the item at channel offset c0, as [dense row]
// [dense column] (16-byte loads, zero outside the image). Lanes 8k .. 8k+7
// hold 8 consecutive tiles of one channel group: the window's left column
// (pixel j-1, qx = 1) is the left lane's third column and the right one
// (pixel j+1, qx = 0) the right lane's second, so only the group's first
// lane loads the left column and its last the right. Called by whole warps.
__device__ __forceinline__ void load_window(Window w, int c0, long long row_stride, int cin,
                                            uint4 (&d)[4][4]) {
  const int lane8 = threadIdx.x & 7;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int dr = 0; dr < 4; ++dr) {
    // Dense row 2i-1+dr is s2d row i+di, parity qy.
    const int di = (dr + 1) / 2 - 1, qy = (dr + 1) & 1;
    const bool row_ok = (w.valid & kTile) &&
                        (dr == 0 ? (w.valid & kUp) : dr == 3 ? (w.valid & kDown) : true);
    const __nv_bfloat16* row = w.src + c0 + di * row_stride + 2 * qy * cin;
    const bool left_ok = row_ok && lane8 == 0 && (w.valid & kLeft);
    const bool right_ok = row_ok && lane8 == 7 && (w.valid & kRight);
    d[dr][0] = left_ok ? __ldg(reinterpret_cast<const uint4*>(row - 3 * cin)) : zero;
    d[dr][1] = row_ok ? __ldg(reinterpret_cast<const uint4*>(row)) : zero;
    d[dr][2] = row_ok ? __ldg(reinterpret_cast<const uint4*>(row + cin)) : zero;
    d[dr][3] = right_ok ? __ldg(reinterpret_cast<const uint4*>(row + 4 * cin)) : zero;
  }
#pragma unroll
  for (int dr = 0; dr < 4; ++dr) {
    // A neighbour's pixel lies in this tile's row whenever the window column
    // is inside the image; otherwise the column stays zero.
    const uint4 left = shfl_lane(d[dr][2], true);
    const uint4 right = shfl_lane(d[dr][1], false);
    if (lane8 != 0 && (w.valid & kLeft)) d[dr][0] = left;
    if (lane8 != 7 && (w.valid & kRight)) d[dr][3] = right;
  }
}

// The 16 V_ab of one tile for 8 channels from its window: B^T d B in
// float32, rounded once to bf16, written as row t of each V_ab (`dst` is
// that row in V_00).
__device__ __forceinline__ void transform_window(uint4 (&raw)[4][4], unsigned char* dst) {
  // One pair of channels (one 32-bit word of every position) at a time, so
  // that the window's registers free up as the outputs fill theirs.
  uint4 out[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float d[4][4][2];
#pragma unroll
    for (int dr = 0; dr < 4; ++dr)
#pragma unroll
      for (int dc = 0; dc < 4; ++dc) {
        const uint32_t w = word(raw[dr][dc], k);
        d[dr][dc][0] = __uint_as_float(w << 16);
        d[dr][dc][1] = __uint_as_float(w & 0xFFFF0000u);
      }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float r[4][2];
#pragma unroll
      for (int dc = 0; dc < 4; ++dc)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          r[dc][c] = bt(a, d[0][dc][c], d[1][dc][c], d[2][dc][c], d[3][dc][c]);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        word(out[a * 4 + b], k) = pack_bf16x2(bt(b, r[0][0], r[1][0], r[2][0], r[3][0]),
                                              bt(b, r[0][1], r[1][1], r[2][1], r[3][1]));
    }
  }
#pragma unroll
  for (int ab = 0; ab < 16; ++ab) *reinterpret_cast<uint4*>(dst + ab * kVMat) = out[ab];
}

template <bool FOLDED>
__device__ __forceinline__ void produce(const __nv_bfloat16* __restrict__ x,
                                        const __nv_bfloat16* __restrict__ u, unsigned char* smem,
                                        int ntiles, int gh, int gw, int cin, int ncb,
                                        long long nitems) {
  using C = Cfg<FOLDED>;
  static_assert(kM * kKc / 8 == kProducerThreads, "one (tile, 8 channels) item per thread");
  const int pt = threadIdx.x - kConsumerThreads;
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + C::kBarOffset, empty0 = full0 + 8 * kStages;
  const int nchunks = cin / kKc;
  const long long row_stride = 4LL * gw * cin;
  // This thread's item: tile t (8 consecutive tiles per 8 lanes, so that a
  // quarter warp stores one 128-byte core matrix) and channel group g.
  const int g = (pt >> 3) & 1, t = (pt >> 4) * 8 + (pt & 7);
  const int vrow = g * kVLbo + (t >> 3) * kCoreBytes + (t & 7) * 16;
  int stage = 0;
  uint32_t phase = 0;
  for (long long item = blockIdx.x; item < nitems; item += gridDim.x) {
    const int cb = static_cast<int>(item % ncb);
    const Window w = window_of(x, item, ncb, t, g, ntiles, gh, gw, cin);
    const __nv_bfloat16* urun = u + static_cast<long long>(cb) * nchunks * (C::kUBytes / 2);
    for (int ch = 0; ch < nchunks; ++ch) {
      const uint32_t full = full0 + 8 * stage;
      mbar_wait(empty0 + 8 * stage, phase ^ 1);
      const uint32_t sbase = base + stage * C::kStageBytes;
      if (pt == 0) {
        mbar_arrive_expect_tx(full, C::kUBytes);
        bulk_load(sbase + kVBytes, urun + static_cast<long long>(ch) * (C::kUBytes / 2),
                  C::kUBytes, full);
      }
      uint4 d[4][4];
      load_window(w, ch * kKc, row_stride, cin, d);
      transform_window(d, smem + stage * C::kStageBytes + vrow);
      // The V rows were written by this thread; wgmma reads them through the
      // async proxy.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// A^T of F(2,3): [[1, 1, 1, 0], [0, 1, -1, -1]].
__host__ __device__ constexpr int at(int r, int a) {
  return r == 0 ? (a < 3 ? 1 : 0) : (a == 0 ? 0 : a == 1 ? 1 : -1);
}

// y(r,s) += A^T[r][a] A^T[s][b] V_ab @ U_ab over the 36 (a, b, r, s) with
// both coefficients nonzero: one k16 step into the 4 accumulators y[2r+s].
// Unfolded, U_ab is U[4a+b]; folded, it is UF[2b+r] block a-r, which
// already carries A^T[r][a]. Each V_ab is loaded into registers once, into
// one of 4 fragments in turn, and its products form one wgmma group; a
// fragment is loaded again only after the group that read it completed.
template <bool FOLDED>
__device__ __forceinline__ void products(float (&y)[4][Cfg<FOLDED>::kNc / 2], uint32_t vb,
                                         uint64_t db, int warp, int lane) {
  using C = Cfg<FOLDED>;
  uint32_t frag[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      uint32_t (&f)[4] = frag[b];
      if (a > 0) wgmma_wait<3>();
      load_a(f, vb + (4 * a + b) * kVMat, warp, lane);
      wgmma_fence();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (at(r, a) == 0) continue;
        const int um = FOLDED ? 3 * (2 * b + r) + a - r : 4 * a + b;
        const uint64_t ub = db + um * (C::kUMat >> 4);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if (at(s, b) == 0) continue;
          if ((FOLDED ? 1 : at(r, a)) * at(s, b) > 0) {
            wgmma_m64k16<C::kNc, 1>(y[2 * r + s], f, ub);
          } else {
            wgmma_m64k16<C::kNc, -1>(y[2 * r + s], f, ub);
          }
        }
      }
      wgmma_commit();
    }
  wgmma_wait<0>();
}

template <bool FOLDED>
__device__ __forceinline__ void consume(const float* __restrict__ bias,
                                        __nv_bfloat16* __restrict__ y, unsigned char* smem,
                                        int ntiles, int cin, int cout, int ncb,
                                        long long nitems) {
  using C = Cfg<FOLDED>;
  constexpr int kR = C::kNc / 2;  // accumulator registers of one output q
  const int wgi = threadIdx.x / 128;  // consumer 0 or 1: output columns c*kNc ..
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + C::kBarOffset, empty0 = full0 + 8 * kStages;
  const int nchunks = cin / kKc;
  int stage = 0;
  uint32_t phase = 0;
  for (long long item = blockIdx.x; item < nitems; item += gridDim.x) {
    const int cb = static_cast<int>(item % ncb);
    const long long tile0 = item / ncb * kM;
    float acc[4][kR];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < kR; ++e) acc[q][e] = 0.f;
    for (int ch = 0; ch < nchunks; ++ch) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t vb = base + stage * C::kStageBytes;
      const uint64_t db =
          make_desc(vb + kVBytes + wgi * (C::kNc / 8) * kCoreBytes, C::kULbo, kCoreBytes);
#pragma unroll
      for (int q = 0; q < 4; ++q) fence_acc(acc[q]);
      products<FOLDED>(acc, vb, db, warp, lane);
#pragma unroll
      for (int q = 0; q < 4; ++q) fence_acc(acc[q]);
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // Epilogue. Element e of an accumulator is row 16*warp + lane/4 +
    // 8*((e/2)%2), column 8*(e/4) + 2*(lane%4) + e%2 of this consumer's
    // kNc. y(q) plus the bias, rounded once to bf16; per row and 4 column
    // blocks, the quad's words are transposed so that each lane stores one
    // block's 16 bytes.
    const int co0 = cb * C::kN + wgi * C::kNc;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long p = tile0 + 16 * warp + lane / 4 + 8 * h;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j4 = 0; j4 < C::kNc / 32; ++j4) {
          uint32_t w[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = 4 * j4 + k;
            const float2 bv =
                *reinterpret_cast<const float2*>(bias + co0 + 8 * j + 2 * (lane % 4));
            w[k] = pack_bf16x2(acc[q][4 * j + 2 * h] + bv.x, acc[q][4 * j + 2 * h + 1] + bv.y);
          }
          quad_transpose(w);
          if (p < ntiles) {
            *reinterpret_cast<uint4*>(y + (p * 4 + q) * cout + co0 + 8 * (4 * j4 + lane % 4)) =
                make_uint4(w[0], w[1], w[2], w[3]);
          }
        }
      }
    }
  }
}

// 1-D grid of at most one block per SM; block b takes work items b, b +
// gridDim.x, ...: item = tile block * (Cout / kN) + column block.
template <bool FOLDED>
__global__ void __launch_bounds__(kThreads, 1)
winograd_s2d_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ u, const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ y, int ntiles, int gh, int gw, int cin,
                          int cout) {
  using C = Cfg<FOLDED>;
  extern __shared__ __align__(1024) unsigned char smem[];
  if (threadIdx.x == 0) {
    const uint32_t full0 = smem_u32(smem + C::kBarOffset);
    for (int s = 0; s < kStages; ++s) {
      // full: the producer's 128 threads and its expect_tx arrival; empty:
      // the consumers' 8 warps.
      mbar_init(full0 + 8 * s, kProducerThreads + 1);
      mbar_init(full0 + 8 * (kStages + s), kConsumerThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ncb = cout / C::kN;
  const long long nitems = static_cast<long long>((ntiles + kM - 1) / kM) * ncb;
  if (threadIdx.x >= kConsumerThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    produce<FOLDED>(x, u, smem, ntiles, gh, gw, cin, ncb, nitems);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    consume<FOLDED>(bias, y, smem, ntiles, cin, cout, ncb, nitems);
  }
}

template <bool FOLDED>
cudaError_t launch(const void* x, const void* u, const float* bias, void* y, int ntiles, int gh,
                   int gw, int cin, int cout, cudaStream_t stream) {
  using C = Cfg<FOLDED>;
  auto kernel = winograd_s2d_wgmma_kernel<FOLDED>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  // setmaxnreg's counts assume the block starts with kLaunchRegs a thread;
  // with fewer, the consumers' request could never be met.
  if (attr.numRegs != kLaunchRegs) return cudaErrorInvalidKernelImage;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long nitems = static_cast<long long>((ntiles + kM - 1) / kM) * (cout / C::kN);
  const int grid = static_cast<int>(nitems < sms ? nitems : sms);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(u), bias,
      static_cast<__nv_bfloat16*>(y), ntiles, gh, gw, cin, cout);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace
}  // namespace unet

// x: (N, GH, GW, 4*Cin) q-major s2d, contiguous, float32 or bfloat16
// (`dtype`); bias: (Cout,) float32; y: (N, GH, GW, 4*Cout) in x's dtype; x,
// u and y 16-byte aligned. u in x's dtype: bfloat16, packed by
// kernels/winograd.py::pack_weights ((Cout/N, Cin/16, mats, 2, N/8, 8, 8),
// N = 128, or 64 folded), Cin a multiple of 32 and Cout of N; float32, (16, Cin, Cout) or (8,
// 3*Cin, Cout) with `folded`, Cin a multiple of 32 and Cout of 64.
extern "C" int unet_winograd_s2d_fwd(const void* x, const void* u, const void* bias, void* y,
                                     int dtype, int folded, long long n, int gh, int gw, int cin,
                                     int cout, void* stream) {
  if (n <= 0 || gh <= 0 || gw <= 0 || cin <= 0 || cin % 32 != 0 || cout <= 0) {
    return cudaErrorInvalidValue;
  }
  const long long ntiles = n * gh * gw;
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bias);
  if (dtype == unet::kBFloat16) {
    const int block_n = folded ? unet::wg::Cfg<true>::kN : unet::wg::Cfg<false>::kN;
    if (cout % block_n != 0 || ntiles > INT_MAX - unet::wg::kM) return cudaErrorInvalidValue;
    const int nt = static_cast<int>(ntiles);
    return folded ? unet::wg::launch<true>(x, u, b, y, nt, gh, gw, cin, cout, s)
                  : unet::wg::launch<false>(x, u, b, y, nt, gh, gw, cin, cout, s);
  }
  if (dtype == unet::kFloat32) {
    if (cout % unet::f32::kCob != 0 || cout / unet::f32::kCob > 65535) {
      return cudaErrorInvalidValue;
    }
    auto xf = static_cast<const float*>(x);
    auto uf = static_cast<const float*>(u);
    auto yf = static_cast<float*>(y);
    return folded ? unet::f32::launch<true>(xf, uf, b, yf, ntiles, gh, gw, cin, cout, s)
                  : unet::f32::launch<false>(xf, uf, b, yf, ntiles, gh, gw, cin, cout, s);
  }
  return cudaErrorInvalidValue;
}
