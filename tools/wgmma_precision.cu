// How many bits of a sum the Hopper tensor cores keep: one instruction's
// products of 1, -1 and a small 2^-e, summed from zero, on
//   fp8  wgmma m64n8k32 (e5m2 or e4m3 operands, float32 result),
//   f16  wgmma m64n8k16 (f16 operands, float32 result),
//   fp8  mma.sync m16n8k32 (e5m2 or e4m3), the instruction of the fp8 conv's
//        general kernel (unet_implementations_tpu_torch/kernels/csrc/fp8_conv.cu).
// A (64 rows x K) and B (K x 8) arrive in shared memory in wgmma's no-swizzle
// K-major core-matrix order: A as [K/kc][64][kc], B as [K/kc][8][kc], kc the
// elements of 16 bytes. Run by tools/wgmma_precision.py.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// mode 0: fp8 e5m2 wgmma, 1: fp8 e4m3 wgmma, 2: f16 wgmma, 3: e5m2 mma.sync,
// 4: e4m3 mma.sync. a: 64 x 32 bytes, b: 8 x 32 bytes, d: 64 x 8 floats.
__global__ void probe(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                      float* __restrict__ d, int mode) {
  __shared__ __align__(1024) uint8_t sa[64 * 32];
  __shared__ __align__(1024) uint8_t sb[8 * 32];
  const int t = threadIdx.x;
  for (int i = t; i < 64 * 32; i += 128) sa[i] = a[i];
  for (int i = t; i < 8 * 32; i += 128) sb[i] = b[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int warp = t / 32, lane = t % 32;
  if (mode <= 2) {
    // K-major core matrices: the two 16-byte groups of K are 64 * 16 (A) and
    // 8 * 16 (B) bytes apart, the 8-row groups 128.
    const uint64_t ad = make_desc(smem_u32(sa), 64 * 16, 128);
    const uint64_t bd = make_desc(smem_u32(sb), 8 * 16, 128);
    float r0 = 0.f, r1 = 0.f, r2 = 0.f, r3 = 0.f;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    if (mode == 0) {
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
                   "wgmma.mma_async.sync.aligned.m64n8k32.f32.e5m2.e5m2 {%0, %1, %2, %3}, %4, %5, "
                   "p, 1, 1;\n}\n"
                   : "+f"(r0), "+f"(r1), "+f"(r2), "+f"(r3) : "l"(ad), "l"(bd), "r"(0));
    } else if (mode == 1) {
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
                   "wgmma.mma_async.sync.aligned.m64n8k32.f32.e4m3.e4m3 {%0, %1, %2, %3}, %4, %5, "
                   "p, 1, 1;\n}\n"
                   : "+f"(r0), "+f"(r1), "+f"(r2), "+f"(r3) : "l"(ad), "l"(bd), "r"(0));
    } else {
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
                   "wgmma.mma_async.sync.aligned.m64n8k16.f32.f16.f16 {%0, %1, %2, %3}, %4, %5, "
                   "p, 1, 1, 0, 0;\n}\n"
                   : "+f"(r0), "+f"(r1), "+f"(r2), "+f"(r3) : "l"(ad), "l"(bd), "r"(0));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    // Row 16 * warp + lane / 4 (+ 8), columns 2 * (lane % 4) (+ 1).
    const int row = 16 * warp + lane / 4, col = 2 * (lane % 4);
    d[row * 8 + col] = r0;
    d[row * 8 + col + 1] = r1;
    d[(row + 8) * 8 + col] = r2;
    d[(row + 8) * 8 + col + 1] = r3;
    return;
  }
  // mma.sync m16n8k32: each warp takes rows 16 * warp .. + 15 (64 rows).
  // Fragments from the same core-matrix order: element (m, k) of A at
  // (k / 16) * 1024 + m * 16 + k % 16, of B (k, n) at (k / 16) * 128 + n * 16
  // + k % 16.
  const int gq = lane / 4, tq = lane % 4, m0 = 16 * warp;
  auto word = [](const uint8_t* p) { return *reinterpret_cast<const uint32_t*>(p); };
  uint32_t fa[4], fb[2];
  fa[0] = word(sa + (m0 + gq) * 16 + tq * 4);
  fa[1] = word(sa + (m0 + gq + 8) * 16 + tq * 4);
  fa[2] = word(sa + 1024 + (m0 + gq) * 16 + tq * 4);
  fa[3] = word(sa + 1024 + (m0 + gq + 8) * 16 + tq * 4);
  fb[0] = word(sb + gq * 16 + tq * 4);
  fb[1] = word(sb + 128 + gq * 16 + tq * 4);
  float r[4];
  const float z = 0.f;
  if (mode == 3) {
    asm volatile("mma.sync.aligned.m16n8k32.row.col.f32.e5m2.e5m2.f32 {%0,%1,%2,%3}, "
                 "{%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
                 : "=f"(r[0]), "=f"(r[1]), "=f"(r[2]), "=f"(r[3])
                 : "r"(fa[0]), "r"(fa[1]), "r"(fa[2]), "r"(fa[3]), "r"(fb[0]), "r"(fb[1]),
                   "f"(z), "f"(z), "f"(z), "f"(z));
  } else {
    asm volatile("mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 {%0,%1,%2,%3}, "
                 "{%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
                 : "=f"(r[0]), "=f"(r[1]), "=f"(r[2]), "=f"(r[3])
                 : "r"(fa[0]), "r"(fa[1]), "r"(fa[2]), "r"(fa[3]), "r"(fb[0]), "r"(fb[1]),
                   "f"(z), "f"(z), "f"(z), "f"(z));
  }
  const int row = m0 + gq, col = 2 * tq;
  d[row * 8 + col] = r[0];
  d[row * 8 + col + 1] = r[1];
  d[(row + 8) * 8 + col] = r[2];
  d[(row + 8) * 8 + col + 1] = r[3];
}

}  // namespace

extern "C" int run_probe(const void* a, const void* b, void* d, int mode) {
  probe<<<1, 128>>>(static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
                    static_cast<float*>(d), mode);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}
