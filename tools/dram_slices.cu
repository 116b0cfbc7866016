// Read-rate kernels of tools/dram_slices.py: one that reads a slice of every
// pixel, and one whose blocks read pieces of pixels x a slice.
#include <cuda_runtime.h>
#include <stdint.h>
// Reads vectors [lo, lo + cnt) (16 B each) of every pixel of x (npix pixels of nvp vectors).
__global__ void rd(const uint4* __restrict__ x, long long npix, int nvp, int lo, int cnt, unsigned* out) {
  unsigned acc = 0;
  const long long n = npix * cnt;
#pragma unroll 8
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / cnt; const int v = lo + (int)(i % cnt);
    uint4 u = __ldcg(x + p * nvp + v);
    acc ^= u.x ^ u.y ^ u.z ^ u.w;
  }
  if (acc == 0x12345678u) out[0] = acc;
}
// Block k reads slice (k % nslices) of pixel range chunk (k / nslices): like the kernel's pieces.
__global__ void rd_pieces(const uint4* __restrict__ x, long long npix, int nvp, int cnt, int part_px, unsigned* out) {
  unsigned acc = 0;
  const int nslices = nvp / cnt;
  const long long parts = (npix + part_px - 1) / part_px;
  for (long long g = blockIdx.x; g < parts * nslices; g += gridDim.x) {
    const long long part = g / nslices; const int j = (int)(g % nslices);
    const long long p0 = part * part_px, p1 = min(p0 + part_px, npix);
#pragma unroll 8
    for (long long i = threadIdx.x; i < (p1 - p0) * cnt; i += blockDim.x) {
      uint4 u = __ldcg(x + (p0 + i / cnt) * nvp + j * cnt + i % cnt);
      acc ^= u.x ^ u.y ^ u.z ^ u.w;
    }
  }
  if (acc == 0x12345678u) out[0] = acc;
}
extern "C" int launch_rd(const void* x, long long npix, int nvp, int lo, int cnt, void* out, int grid, int block) {
  rd<<<grid, block>>>((const uint4*)x, npix, nvp, lo, cnt, (unsigned*)out);
  return cudaGetLastError();
}
extern "C" int launch_pieces(const void* x, long long npix, int nvp, int cnt, int part_px, void* out, int grid, int block) {
  rd_pieces<<<grid, block>>>((const uint4*)x, npix, nvp, cnt, part_px, (unsigned*)out);
  return cudaGetLastError();
}
