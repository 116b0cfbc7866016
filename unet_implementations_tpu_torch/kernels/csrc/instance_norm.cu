// K1: fused InstanceNorm + LeakyReLU, forward and backward, for Hopper (sm_90a).
//
// The forward replaces unet_implementations_tpu/kernels/instance_norm.py::
// _pallas_forward (its two pallas_calls, _stats_kernel and _normalize_kernel);
// the backward is the counterpart of that module's custom_vjp backward,
// _bwd_impl, which JAX leaves to XLA.
//
//   y = lrelu((x - mean) * rstd * scale + bias)        per (image, channel)
//
// mean and the biased variance come from float32 sums of x and x*x over H*W
// (and over the `group` q-major sub-pixel blocks, channel = q*Cg + c, when
// group > 1); rstd = 1/sqrt(var + eps). y is computed in float32 and rounded
// once to x's dtype.
//
// Bound: bytes. A forward must read x once and write y once (4 bytes an
// element in bf16, against ~10 flops: far below the card's ~295 flops/byte);
// a backward must read x and dy and write dx (6 bytes). The statistics need a
// whole pass over an image before any output of it can be written.
//
// Forward, two launches, each reading x (so at best 2/3 of its bound). Both
// tile (image, chunk of pixels): a thread keeps the same VEC channels for the
// whole block (threads of a pixel row read neighbouring 16-byte vectors, the
// block's rows stride over the chunk), so its per-channel parameters sit in
// registers, and it keeps kUnroll 16-byte loads of each input in flight.
// Hopper's blocks run in no order, so each block of the first pass writes
// float32 partial sums, and the last block to finish an image (an atomic
// count per image, after a __threadfence) adds that image's partials in a
// fixed order, once. No atomic touches a sum, so runs repeat bit for bit.
// The second pass walks the blocks in reverse, so it starts on the images
// the first pass read last, which are still in the 50 MB L2.
//   1. in_stats_kernel: per (image, chunk, channel) partials of x and x*x; an
//      image's last block turns them into its mean and rstd.
//   2. in_apply_kernel: normalize and activate.
// When an image's rows are spread over several processes (spatial
// partitioning, parallel/spatial.py), the statistics pass runs without its
// finalize (unet_instance_norm_partials), the caller adds the partials up over
// the processes, in_finalize_kernel turns the sums into mean and rstd with the
// whole image's pixel count (unet_instance_norm_finalize), and the apply pass
// follows.
//
// Backward (dx in x's dtype, dscale and dbias float32), by shape
// (kernels/instance_norm.py::bwd_plan):
//
// The fused kernel, where x and dy cross HBM once: one cooperative launch of
// in_bwd_fused_kernel, one block per SM, all resident, holds what it reads in
// shared memory until the statistics it needs are out, then writes dx from
// there.
//   - The work is cut into (image, slice) pairs, a slice being `cs` original
//     channels with all `group` q blocks, 64 bytes of each q block's pixel (a
//     DRAM segment; 32 bytes, a sector, where 64 would need too many pieces),
//     and a pair into `parts` pieces of part_px pixels, so that a block's
//     ring holds three of its pieces. parts divides the grid, so a round of
//     grid pieces holds whole pairs. The cut depends on the image's shape and
//     the card alone, never on the batch.
//   - Roles. A producer warp copies each piece's steps (rows pixels of x and
//     of dy) into the ring with 16-byte cp.async copies, against a full and an
//     empty mbarrier a slot, keeping kInflightBytes in flight. The compute
//     threads reduce a piece: xhat = (x - mean) * rstd and the
//     pre-activation xhat * scale + bias with the forward's roundings
//     (bwd_terms), so each element takes the slope the forward gave it; dpre
//     = dy * lrelu'(pre); per-thread sums of dpre and dpre * xhat, then
//     butterflies within each warp. A publisher warp adds the warps' sums in
//     a fixed order into the piece's row of partials, each float stored in
//     one 64-bit word beside the call's tag, and adds one to the pair's
//     count. A waiter warp polls the count; once it reads parts, it adds the
//     pair's rows in part order (a row's tags prove it is this call's; a late
//     one is read again) into a buffer of shared memory and releases the
//     compute threads, which take m1 = scale * Σdpre / n and m2 = scale *
//     Σ(dpre * xhat) / n, and write dx = rstd * (dpre * scale - m1 - xhat *
//     m2) in the plain version's order from the ring, handing each step back
//     to the producer.
//   - Only the publisher and waiter touch another block's memory, and no
//     thread fences: a fence would wait for its own copies and stores, and
//     every block's count and poll would queue behind them.
//   - The compute threads reduce the next piece before they apply this one
//     when the ring keeps room for kLoadingSteps more, so the pair's wait
//     hides behind that reduce.
// The two-pass kernel, for the shapes whose round holds fewer than four pairs
// (levels 0 and 1 of the 6-stage model at 512², its s2d norms, images of
// 1024²): there every piece waits on a pair spread over most of the card,
// its reduce, wait and apply run in series, and the fused kernel was measured
// slower (PERF.md); and for every shape when an image's rows are spread over
// several processes, whose sums are added up over them between the reduce
// and the apply. Three launches on a (nchunk, B) grid:
//   1. in_bwd_reduce_kernel: the partials of dpre and dpre * xhat; an image's
//      last block adds them into the image's Σdpre and Σ(dpre * xhat).
//   2. in_bwd_apply_kernel: dx as above, reading x and dy again, walking the
//      blocks in reverse so that the last images' second read hits L2.
//   3. in_bwd_params_kernel (both kernels): dbias = Σdpre and dscale =
//      Σ(dpre * xhat) over the images, in order.
// No atomic touches a sum in either, so a second call repeats the first bit
// for bit. The plain version sums dxhat = dpre * scale, rounded per element;
// the factored m1, m2 differ from it by float32 rounding only.
#include "hopper.cuh"
#include "instance_norm.cuh"

namespace unet {
namespace {

constexpr int kThreads = 256;  // threads a block aims for
constexpr int kUnroll = 4;     // 16-byte loads of each input a thread keeps in flight
// The apply pass of the s2d block tail's IN2, which is given mean and rstd,
// cuts an image into at most this many chunks of at least kMinChunkBytes (the
// rule of kernels/instance_norm.py::chunking).
constexpr int kMaxChunks = 32;
constexpr long long kMinChunkBytes = 64 * 1024;
// The backward's block: at most this many threads (pixel rows of a slice times
// the vectors of one of its pixels), and its ring's steps at most (one
// cp.async group each, waited on with a constant).
constexpr int kBwdThreads = 416;
constexpr int kMaxRingSteps = 32;
// Bytes of copies a block keeps in flight: enough to keep DRAM busy (its
// share of the card's rate times the latency), and no more, since every
// block's publications and polls queue behind them.
constexpr int kInflightBytes = 128 * 1024;

// Threads across one pixel's channels (tc = C / VEC), pixel rows a block
// covers at once, and the block's thread count.
struct Tiling {
  int tc, rows, threads;
};

template <int VEC>
Tiling tiling(int c) {
  const int tc = c / VEC;
  const int rows = tc >= kThreads ? 1 : kThreads / tc;
  return {tc, rows, tc * rows};
}

// Sums two per-thread VEC-vectors over the block's pixel rows in row order and
// writes them as one row of partials: out[ch] and out[c + ch].
template <int VEC>
__device__ __forceinline__ void write_row_sums(const float (&s1)[VEC], const float (&s2)[VEC],
                                               float* smem, int c, int rows, int cv, int r,
                                               float* __restrict__ out) {
  float* sm1 = smem;             // [rows][c]
  float* sm2 = smem + rows * c;  // [rows][c]
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sm1[r * c + cv * VEC + k] = s1[k];
    sm2[r * c + cv * VEC + k] = s2[k];
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int rr = 0; rr < rows; ++rr) {
      a += sm1[rr * c + ch];
      q += sm2[rr * c + ch];
    }
    out[ch] = a;
    out[c + ch] = q;
  }
}

// Whether this block is the last of image b's `nchunk` blocks to have written
// its row of partials; if so, every block's row is visible to it. `count`
// holds one counter per image, zero before the launch.
__device__ __forceinline__ bool last_of_image(unsigned* count, long long b, int nchunk) {
  __shared__ bool last;
  __threadfence();  // this thread's partials, before the count
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(count + b, 1u) == static_cast<unsigned>(nchunk) - 1;
  __syncthreads();
  if (last) __threadfence();  // the other blocks' partials, after the count
  return last;
}

// Floats of shared memory pool_partials needs.
inline int pool_floats(int threads, int cg) {
  const int lanes = threads / cg > 1 ? threads / cg : 1;
  return 2 * lanes * cg;
}

// One image's rows of partials (B, nrows, 2, C) added per original channel in
// a fixed order: lane s of `lanes` adds rows s, s + lanes, ... (the group's q
// blocks inside each row), then the lanes are added in order. Returns through
// `emit(ch, Σ1, Σ2)`, called once per original channel. The partials are read
// from L2 (other blocks of this launch wrote them). `red` holds
// pool_floats() floats of shared memory.
template <typename Emit>
__device__ void pool_partials(const float* __restrict__ partials, long long b, int nrows, int c,
                              int group, float* red, Emit emit) {
  const int cg = c / group;
  const int lanes = max(1, static_cast<int>(blockDim.x) / cg);
  for (int j = threadIdx.x; j < lanes * cg; j += blockDim.x) {
    const int ch = j % cg;
    const int s = j / cg;
    float a = 0.f, q = 0.f;
#pragma unroll 4
    for (int k = s; k < nrows; k += lanes) {
      const float* row = partials + (b * nrows + k) * 2 * c;
      for (int g = 0; g < group; ++g) {
        a += __ldcg(row + g * cg + ch);
        q += __ldcg(row + c + g * cg + ch);
      }
    }
    red[s * cg + ch] = a;
    red[(lanes + s) * cg + ch] = q;
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < cg; ch += blockDim.x) {
    float a = 0.f, q = 0.f;
    for (int s = 0; s < lanes; ++s) {
      a += red[s * cg + ch];
      q += red[(lanes + s) * cg + ch];
    }
    emit(ch, a, q);
  }
}

// The forward's normalize and activation of one vector, with the plain
// version's op order and roundings (no contraction).
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> norm_act(const Vec<T, VEC>& v, const float (&m)[VEC],
                                                const float (&r)[VEC], const float (&s)[VEC],
                                                const float (&bi)[VEC], float slope) {
  Vec<T, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    float t = __fmul_rn(__fsub_rn(to_f32(v.v[k]), m[k]), r[k]);
    t = __fadd_rn(__fmul_rn(t, s[k]), bi[k]);
    t = t >= 0.f ? t : __fmul_rn(t, slope);
    o.v[k] = from_f32<T>(t);
  }
  return o;
}

// The backward's xhat and dpre = dy * lrelu'(pre) of one element, where pre
// is recomputed with the forward's roundings; returns whether pre >= 0 (the
// slope 1).
__device__ __forceinline__ bool bwd_terms(float xv, float dyv, float m, float r, float s, float bi,
                                          float slope, float& xhat, float& dpre) {
  xhat = __fmul_rn(__fsub_rn(xv, m), r);
  const float pre = __fadd_rn(__fmul_rn(xhat, s), bi);
  const bool up = pre >= 0.f;
  dpre = up ? dyv : __fmul_rn(dyv, slope);
  return up;
}

// dx of one vector: (dpre * scale - m1 - xhat * m2) * rstd, in the plain
// version's order, rounded once to T.
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> input_grad(const Vec<T, VEC>& xv, const Vec<T, VEC>& gv,
                                                  const float (&m)[VEC], const float (&r)[VEC],
                                                  const float (&s)[VEC], const float (&bi)[VEC],
                                                  const float (&m1)[VEC],
                                                  const float (&m2)[VEC], float slope) {
  Vec<T, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    float xhat, dpre;
    bwd_terms(to_f32(xv.v[k]), to_f32(gv.v[k]), m[k], r[k], s[k], bi[k], slope, xhat, dpre);
    float t = __fsub_rn(__fmul_rn(dpre, s[k]), m1[k]);
    t = __fsub_rn(t, __fmul_rn(xhat, m2[k]));
    o.v[k] = from_f32<T>(__fmul_rn(t, r[k]));
  }
  return o;
}

// mean and rstd from Σx and Σx² with the plain version's op order: s1/n,
// s2/n - m*m, no contraction.
__device__ __forceinline__ void mean_rstd(float s1, float s2, float n, float eps, float& m,
                                          float& rs) {
  m = __fdiv_rn(s1, n);
  const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, n), __fmul_rn(m, m)), 0.f);
  rs = __frsqrt_rn(__fadd_rn(var, eps));
}

// grid (nchunk, B): partials of x and x*x per (image, chunk, channel). With
// FINALIZE, an image's last block stores its mean and rstd (per channel,
// repeated over the group's q blocks).
template <typename T, int VEC, bool FINALIZE>
__global__ void in_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                                float* __restrict__ mean, float* __restrict__ rstd,
                                unsigned* __restrict__ count, long long hw, int c, int group,
                                int chunk_px, int nchunk, float n, float eps) {
  extern __shared__ float smem[];
  const int tc = c / VEC;
  const int rows = blockDim.x / tc;
  const int cv = threadIdx.x % tc;
  const int r = threadIdx.x / tc;
  const int chunk = blockIdx.x;
  const long long b = blockIdx.y;
  const long long p0 = static_cast<long long>(chunk) * chunk_px;
  const long long p1 = min(p0 + chunk_px, hw);

  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) { s1[k] = 0.f; s2[k] = 0.f; }
  const T* xb = x + b * hw * c + cv * VEC;
  long long p = p0 + r;
  for (; p + (kUnroll - 1) * rows < p1; p += kUnroll * rows) {
    Vec<T, VEC> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load_vec<T, VEC>(xb + (p + u * rows) * c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float f = to_f32(v[u].v[k]);
        s1[k] += f;
        s2[k] += f * f;
      }
    }
  }
  for (; p < p1; p += rows) {
    const Vec<T, VEC> v = load_vec<T, VEC>(xb + p * c);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float f = to_f32(v.v[k]);
      s1[k] += f;
      s2[k] += f * f;
    }
  }
  write_row_sums<VEC>(s1, s2, smem, c, rows, cv, r, partials + (b * nchunk + chunk) * 2 * c);
  if (FINALIZE && last_of_image(count, b, nchunk)) {
    const int cg = c / group;
    pool_partials(partials, b, nchunk, c, group, smem, [&](int ch, float a, float q) {
      float m, rs;
      mean_rstd(a, q, n, eps, m, rs);
      for (int g = 0; g < group; ++g) {
        mean[b * c + g * cg + ch] = m;
        rstd[b * c + g * cg + ch] = rs;
      }
    });
  }
}

// grid (ceil(cg / 32), B), block (32, 8): x walks channels, y walks chunks.
// The s2d block tail's statistics, whose partials its conv writes.
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
    float m, rs;
    mean_rstd(a, q, n, eps, m, rs);
    for (int g = 0; g < group; ++g) {
      mean[b * c + g * cg_count + cg] = m;
      rstd[b * c + g * cg_count + cg] = rs;
    }
  }
}

// grid (nchunk, B), walked in reverse: y from x and the per-(image, channel)
// mean and rstd.
template <typename T, int VEC>
__global__ void in_apply_kernel(const T* __restrict__ x, T* __restrict__ y,
                                const float* __restrict__ mean, const float* __restrict__ rstd,
                                const float* __restrict__ scale, const float* __restrict__ bias,
                                long long hw, int c, int group, int chunk_px, float slope) {
  const int cg = c / group;
  const int tc = c / VEC;
  const int rows = blockDim.x / tc;
  const int cv = threadIdx.x % tc;
  const int r = threadIdx.x / tc;
  const int chunk = gridDim.x - 1 - blockIdx.x;
  const long long b = gridDim.y - 1 - blockIdx.y;
  float pm[VEC], pr[VEC], ps[VEC], pb[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int ch = cv * VEC + k;
    pm[k] = mean[b * c + ch];
    pr[k] = rstd[b * c + ch];
    ps[k] = scale[ch % cg];
    pb[k] = bias[ch % cg];
  }
  const long long p0 = static_cast<long long>(chunk) * chunk_px;
  const long long p1 = min(p0 + chunk_px, hw);
  const T* xb = x + b * hw * c + cv * VEC;
  T* yb = y + b * hw * c + cv * VEC;
  long long p = p0 + r;
  for (; p + (kUnroll - 1) * rows < p1; p += kUnroll * rows) {
    Vec<T, VEC> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load_vec<T, VEC>(xb + (p + u * rows) * c);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      store_vec<T, VEC>(yb + (p + u * rows) * c, norm_act<T, VEC>(v[u], pm, pr, ps, pb, slope));
    }
  }
  for (; p < p1; p += rows) {
    store_vec<T, VEC>(yb + p * c, norm_act<T, VEC>(load_vec<T, VEC>(xb + p * c), pm, pr, ps, pb,
                                                   slope));
  }
}

// The two-pass backward (shapes whose pairs need every block, see
// kernels/instance_norm.py::bwd_plan), grid (nchunk, B): partials of dpre and
// dpre * xhat per (image, chunk, channel); an image's last block stores the image's Σdpre and Σ(dpre * xhat)
// per original channel to img_sums (B, 2, cg).
template <typename T, int VEC>
__global__ void in_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ rstd,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ bias,
                                     float* __restrict__ partials, float* __restrict__ img_sums,
                                     unsigned* __restrict__ count, long long hw, int c,
                                     int group, int chunk_px, int nchunk, float slope) {
  extern __shared__ float smem[];
  const int cg = c / group;
  const int tc = c / VEC;
  const int rows = blockDim.x / tc;
  const int cv = threadIdx.x % tc;
  const int r = threadIdx.x / tc;
  const int chunk = blockIdx.x;
  const long long b = blockIdx.y;
  float pm[VEC], pr[VEC], ps[VEC], pb[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int ch = cv * VEC + k;
    pm[k] = mean[b * c + ch];
    pr[k] = rstd[b * c + ch];
    ps[k] = scale[ch % cg];
    pb[k] = bias[ch % cg];
  }
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) { s1[k] = 0.f; s2[k] = 0.f; }
  const long long p0 = static_cast<long long>(chunk) * chunk_px;
  const long long p1 = min(p0 + chunk_px, hw);
  const T* xb = x + b * hw * c + cv * VEC;
  const T* gb = dy + b * hw * c + cv * VEC;
  long long p = p0 + r;
  for (; p + (kUnroll - 1) * rows < p1; p += kUnroll * rows) {
    Vec<T, VEC> xv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xv[u] = load_vec<T, VEC>(xb + (p + u * rows) * c);
      gv[u] = load_vec<T, VEC>(gb + (p + u * rows) * c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float xhat, dpre;
        bwd_terms(to_f32(xv[u].v[k]), to_f32(gv[u].v[k]), pm[k], pr[k], ps[k], pb[k], slope,
                  xhat, dpre);
        s1[k] += dpre;
        s2[k] += dpre * xhat;
      }
    }
  }
  for (; p < p1; p += rows) {
    const Vec<T, VEC> xv = load_vec<T, VEC>(xb + p * c);
    const Vec<T, VEC> gv = load_vec<T, VEC>(gb + p * c);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float xhat, dpre;
      bwd_terms(to_f32(xv.v[k]), to_f32(gv.v[k]), pm[k], pr[k], ps[k], pb[k], slope, xhat, dpre);
      s1[k] += dpre;
      s2[k] += dpre * xhat;
    }
  }
  write_row_sums<VEC>(s1, s2, smem, c, rows, cv, r, partials + (b * nchunk + chunk) * 2 * c);
  if (last_of_image(count, b, nchunk)) {
    pool_partials(partials, b, nchunk, c, group, smem, [&](int ch, float a, float q) {
      img_sums[b * 2 * cg + ch] = a;
      img_sums[b * 2 * cg + cg + ch] = q;
    });
  }
}

// grid (nchunk, B), walked in reverse: dx.
template <typename T, int VEC>
__global__ void in_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                    const float* __restrict__ mean,
                                    const float* __restrict__ rstd,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ bias,
                                    const float* __restrict__ img_sums, T* __restrict__ dx,
                                    long long hw, int c, int group, int chunk_px, float n,
                                    float slope) {
  const int cg = c / group;
  const int tc = c / VEC;
  const int rows = blockDim.x / tc;
  const int cv = threadIdx.x % tc;
  const int r = threadIdx.x / tc;
  const int chunk = gridDim.x - 1 - blockIdx.x;
  const long long b = gridDim.y - 1 - blockIdx.y;
  float pm[VEC], pr[VEC], ps[VEC], pb[VEC], m1[VEC], m2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const int ch = cv * VEC + k;
    const int pc = ch % cg;
    pm[k] = mean[b * c + ch];
    pr[k] = rstd[b * c + ch];
    ps[k] = scale[pc];
    pb[k] = bias[pc];
    m1[k] = __fdiv_rn(__fmul_rn(ps[k], img_sums[b * 2 * cg + pc]), n);
    m2[k] = __fdiv_rn(__fmul_rn(ps[k], img_sums[b * 2 * cg + cg + pc]), n);
  }
  const long long p0 = static_cast<long long>(chunk) * chunk_px;
  const long long p1 = min(p0 + chunk_px, hw);
  const T* xb = x + b * hw * c + cv * VEC;
  const T* gb = dy + b * hw * c + cv * VEC;
  T* ob = dx + b * hw * c + cv * VEC;
  long long p = p0 + r;
  for (; p + (kUnroll - 1) * rows < p1; p += kUnroll * rows) {
    Vec<T, VEC> xv[kUnroll], gv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      xv[u] = load_vec<T, VEC>(xb + (p + u * rows) * c);
      gv[u] = load_vec<T, VEC>(gb + (p + u * rows) * c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      store_vec<T, VEC>(ob + (p + u * rows) * c,
                        input_grad<T, VEC>(xv[u], gv[u], pm, pr, ps, pb, m1, m2, slope));
    }
  }
  for (; p < p1; p += rows) {
    store_vec<T, VEC>(ob + p * c, input_grad<T, VEC>(load_vec<T, VEC>(xb + p * c),
                                                     load_vec<T, VEC>(gb + p * c), pm, pr, ps,
                                                     pb, m1, m2, slope));
  }
}

// dbias = Σ_b Σdpre and dscale = Σ_b Σ(dpre * xhat), images in order.
__global__ void in_bwd_params_kernel(const float* __restrict__ img_sums,
                                     float* __restrict__ dscale, float* __restrict__ dbias,
                                     long long b, int cg) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= cg) return;
  float a = 0.f, q = 0.f;
  for (long long i = 0; i < b; ++i) {
    a += img_sums[i * 2 * cg + ch];
    q += img_sums[i * 2 * cg + cg + ch];
  }
  dbias[ch] = a;
  dscale[ch] = q;
}

// ---- K1bwd: one persistent, cooperative launch ----
//
// A piece is one block's pixel range [p0, p1) of one (image, slice) pair; a
// pair's `parts` pieces are pieces g = pair * parts + part, and block j takes
// pieces j, j + grid, j + 2 * grid, ... in order.
struct Piece {
  long long pair, img, p0, p1;
  int part, j0, steps;
};

template <typename T>
struct BwdArgs {
  const T* x;
  const T* dy;
  const float* mean;
  const float* rstd;
  const float* scale;
  const float* bias;
  // (pairs, parts, 2, cs) words, one row per piece: tag << 32 | the float's
  // bits. A word is valid once its tag is this call's.
  unsigned long long* partials;
  float* img_sums;  // (B, 2, cg): Σdpre and Σ(dpre * xhat) per image
  unsigned* count;  // (pairs,), zero before the call: the rows published
  T* dx;
  long long b, hw;
  int c, group, cs, nslices, nv, rows, parts, part_px, ring_steps;
  unsigned tag;
  float n, slope;
};

template <typename T>
__device__ __forceinline__ Piece piece_of(const BwdArgs<T>& a, int g) {
  Piece pc;
  const int pair = g / a.parts;
  pc.pair = pair;
  pc.part = g - pair * a.parts;
  pc.img = pair / a.nslices;
  pc.j0 = (pair - static_cast<int>(pc.img) * a.nslices) * a.cs;
  pc.p0 = static_cast<long long>(pc.part) * a.part_px;
  pc.p1 = min(pc.p0 + a.part_px, a.hw);
  pc.steps = static_cast<int>((pc.p1 - pc.p0 + a.rows - 1) / a.rows);
  return pc;
}

// 16 bytes into shared memory; with `segment`, L2 fetches the whole 64-byte
// segment around them from DRAM.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool segment) {
  if (segment) {
    asm volatile("cp.async.cg.shared.global.L2::64B [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  }
}

// An arrival on `bar` once all of this thread's earlier cp.async copies have
// landed (the barrier counts it among its expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Whether the barrier's phase of parity `parity` has completed; no wait.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// One vector from device memory into this thread's ring entry: a cp.async of
// 16 bytes, or (a scalar element) a plain load and store.
template <typename T, int VEC>
__device__ __forceinline__ void copy_to_ring(Vec<T, VEC>* dst, const T* src, bool segment) {
  if constexpr (sizeof(Vec<T, VEC>) == 16) {
    cp_async16(dst, src, segment);
  } else {
    *dst = load_vec<T, VEC>(src);
  }
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ ulonglong2 ld_words(const unsigned long long* p) {
  ulonglong2 v;
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];\n"
               : "=l"(v.x), "=l"(v.y)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// A wait of more than kMaxWaitNs for a pair's count can only be a fault (a
// block that never arrives): it traps, so the launch fails with an error
// instead of holding the card.
constexpr unsigned long long kMaxWaitNs = 10ull * 1000 * 1000 * 1000;

// Named barriers (0 is __syncthreads): kBarRows + b once red buffer b holds
// the compute threads' sums of a piece, for the publisher warp; kBarReady + b
// once the waiter warp has counted every block's row of that piece's pair;
// The compute threads reduce up to
// kLookahead pieces ahead of the one they apply, one red buffer each.
constexpr int kLookahead = 1;
constexpr int kLoadingSteps = 3;
constexpr int kBuffers = kLookahead + 1;
constexpr int kBarRows = 1;
constexpr int kBarReady = kBarRows + kBuffers;

// The non-aligned forms: they count threads, so a warp that reaches the
// barrier diverged (its lanes along different paths) still counts once per
// thread.
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("barrier.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// VEC consecutive floats of read-only device memory into registers, as
// float4 loads where VEC allows (p is then 16-byte aligned).
template <int VEC>
__device__ __forceinline__ void load_floats(const float* p, float (&out)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + k));
      out[k] = f.x;
      out[k + 1] = f.y;
      out[k + 2] = f.z;
      out[k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = __ldg(p + k);
  }
}

// A count of ring steps with its slot and the parity of its slot's use.
struct Cursor {
  long long n = 0;
  int slot = 0;
  uint32_t parity = 0;
  __device__ __forceinline__ void next(int ring_steps) {
    ++n;
    if (++slot == ring_steps) {
      slot = 0;
      parity ^= 1u;
    }
  }
};

// The producer warp: the copies of every kept step, in (piece, step) order,
// into the ring. A step waits for its slot's previous step to be applied
// (empty) and for fewer than `inflight` steps to be on their way; each lane
// copies its share of the step's x and dy vectors, 16 bytes a copy, and
// arrives on the step's full barrier once its copies have landed. A slice narrower than DRAM's 64-byte segment (level
// 0: 32 bytes of each) is read at half DRAM's rate alone; so the first slice
// of each segment fetches the whole segment into L2, where the next pair (the
// next slice of the same image and pixels, a round later) finds its half.
template <typename T, int VEC, bool SHFL>
__device__ void bwd_producer(const BwdArgs<T>& a, long long m, Vec<T, VEC>* ring,
                             uint64_t* full, uint64_t* empty, int tc) {
  using V = Vec<T, VEC>;
  const int lane = threadIdx.x & 31;
  const int cg = a.c / a.group;
  const int slice_bytes = a.cs * static_cast<int>(sizeof(T));
  const int per_segment = slice_bytes < 64 && 64 % slice_bytes == 0 ? 64 / slice_bytes : 1;
  const int inflight = max(1, kInflightBytes / (2 * tc * static_cast<int>(sizeof(V))));
  // With SHFL (nv divides 32), the entries j = lane + 32 u of a lane hold
  // column j % nv, the same for every u, of pixel rows j / nv.
  const int lane_e0 = lane % a.nv * VEC;
  const int lane_col = lane_e0 / a.cs * cg + lane_e0 % a.cs;  // less the slice's j0
  const int lane_row = lane / a.nv;
  const int rows_per_pass = 32 / a.nv;
  const long long pass_stride = static_cast<long long>(rows_per_pass) * a.c;
  Cursor q, landed;
  for (long long i = 0; i < m; ++i) {
    const Piece pc = piece_of(a, static_cast<int>(blockIdx.x + i * gridDim.x));
    const bool segment = per_segment > 1 && pc.j0 / a.cs % per_segment == 0;
    for (int k = 0; k < pc.steps; ++k) {
      if (q.n >= a.ring_steps) mbar_wait(smem_u32(empty + q.slot), q.parity ^ 1u);
      while (q.n - landed.n >= inflight) {
        if (mbar_test(smem_u32(full + landed.slot), landed.parity)) landed.next(a.ring_steps);
      }
      V* step = ring + static_cast<size_t>(q.slot) * 2 * tc;
      const long long p0 = pc.p0 + static_cast<long long>(k) * a.rows;
      if constexpr (SHFL) {
        long long p = p0 + lane_row;
        long long off = (pc.img * a.hw + p) * a.c + pc.j0 + lane_col;
        for (int j = lane; j < tc && p < pc.p1; j += 32, p += rows_per_pass, off += pass_stride) {
          copy_to_ring<T, VEC>(step + j, a.x + off, segment);
          copy_to_ring<T, VEC>(step + tc + j, a.dy + off, segment);
        }
      } else {
        for (int j = lane; j < tc; j += 32) {
          const long long p = p0 + j / a.nv;
          if (p >= pc.p1) continue;
          const int e0 = j % a.nv * VEC;
          const long long off = (pc.img * a.hw + p) * a.c + pc.j0 + e0 / a.cs * cg + e0 % a.cs;
          copy_to_ring<T, VEC>(step + j, a.x + off, segment);
          copy_to_ring<T, VEC>(step + tc + j, a.dy + off, segment);
        }
      }
      if constexpr (VEC > 1) {
        cp_async_arrive(smem_u32(full + q.slot));
      } else {
        mbar_arrive(smem_u32(full + q.slot));
      }
      q.next(a.ring_steps);
    }
  }
}

// The publisher warp, piece by piece: the block's row of sums from red
// (over the compute warps, or the pixel rows and the q blocks, in order) into
// partials, each float in one 64-bit store beside this call's tag, then one
// on the pair's count. A word carries its own validity, so neither needs a
// fence: the count only says when to read, the tags what is there.
template <typename T>
__device__ void bwd_publisher(const BwdArgs<T>& a, long long m, const float* red, int groups,
                              int width, int nq, int all) {
  const int lane = threadIdx.x & 31;
  const int cs = a.cs;
  for (long long i = 0; i < m; ++i) {
    const int buf = static_cast<int>(i % kBuffers);
    const Piece pc = piece_of(a, static_cast<int>(blockIdx.x + i * gridDim.x));
    unsigned long long* row = a.partials + (pc.pair * a.parts + pc.part) * 2 * cs;
    const unsigned long long tag = static_cast<unsigned long long>(a.tag) << 32;
    bar_sync(kBarRows + buf, all);
    const float* rb = red + buf * 2 * groups * width;
    for (int j = lane; j < 2 * cs; j += 32) {
      const int arr = j / cs;
      const int ch = j % cs;
      float u = 0.f;
      for (int q = 0; q < nq; ++q) {
        for (int g = 0; g < groups; ++g) u += rb[(arr * groups + g) * width + q * cs + ch];
      }
      st_word(row + j, tag | __float_as_uint(u));
    }
    __syncwarp();
    if (lane == 0) atomicAdd(a.count + pc.pair, 1u);
  }
}

// The waiter warp adds the `parts` rows of a pair (w tagged words each, w
// even) in a fixed order into sums[w]: lane l sums a column of two words,
// base + l % cols, over rows l / cols, + lanes, ..., up to kPoolLoads rows at
// once: it loads them, then loads again, together, those whose words do not
// carry `tag` yet, until all do; then the lanes are added in order. A wait of
// more than kMaxWaitNs (a block that never publishes) traps.
constexpr int kPoolLoads = 16;

__device__ void pool_rows(const unsigned long long* rows, int parts, int w, unsigned tag,
                          float* sums, int lane) {
  const int nf = w / 2;
  for (int base = 0; base < nf; base += 32) {
    const int cols = min(32, nf - base);
    const int lanes = 32 / cols;
    const int cc = lane % cols;
    const int s = lane / cols;
    float acc0 = 0.f, acc1 = 0.f;
    if (s < lanes) {
      for (int k0 = s; k0 < parts; k0 += lanes * kPoolLoads) {
        ulonglong2 v[kPoolLoads];
#pragma unroll
        for (int u = 0; u < kPoolLoads; ++u) {
          const int k = k0 + u * lanes;
          if (k < parts) v[u] = ld_words(rows + static_cast<long long>(k) * w + 2 * (base + cc));
        }
        const unsigned long long start = global_ns();
        for (;;) {
          bool landed = true;
#pragma unroll
          for (int u = 0; u < kPoolLoads; ++u) {
            if (k0 + u * lanes < parts && ((v[u].x >> 32) != tag || (v[u].y >> 32) != tag)) {
              landed = false;
            }
          }
          if (landed) break;
          if (global_ns() - start > kMaxWaitNs) __trap();
#pragma unroll
          for (int u = 0; u < kPoolLoads; ++u) {
            const int k = k0 + u * lanes;
            if (k < parts && ((v[u].x >> 32) != tag || (v[u].y >> 32) != tag)) {
              v[u] = ld_words(rows + static_cast<long long>(k) * w + 2 * (base + cc));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kPoolLoads; ++u) {
          if (k0 + u * lanes >= parts) break;
          acc0 += __uint_as_float(static_cast<unsigned>(v[u].x));
          acc1 += __uint_as_float(static_cast<unsigned>(v[u].y));
        }
      }
    }
    float tot0 = 0.f, tot1 = 0.f;
    for (int s2 = 0; s2 < lanes; ++s2) {
      tot0 += __shfl_sync(0xFFFFFFFFu, acc0, s2 * cols + cc);
      tot1 += __shfl_sync(0xFFFFFFFFu, acc1, s2 * cols + cc);
    }
    if (s == 0) {
      sums[2 * (base + cc)] = tot0;
      sums[2 * (base + cc) + 1] = tot1;
    }
  }
}

// The waiter warp, piece by piece: polls the pair's count until every block
// has published its row, adds the pair's rows in part order into stage buffer
// `buf` (the block with part 0 keeps them in img_sums for dscale and dbias),
// then releases the compute threads to apply. A wait of more than kMaxWaitNs
// (a block that never publishes) traps.
template <typename T>
__device__ void bwd_waiter(const BwdArgs<T>& a, long long m, float* sums, int all) {
  const int lane = threadIdx.x & 31;
  const int cg = a.c / a.group;
  const int w = 2 * a.cs;
  for (long long i = 0; i < m; ++i) {
    const int buf = static_cast<int>(i % kBuffers);
    const Piece pc = piece_of(a, static_cast<int>(blockIdx.x + i * gridDim.x));
    if (lane == 0) {
      const unsigned long long start = global_ns();
      while (ld_relaxed(a.count + pc.pair) != static_cast<unsigned>(a.parts)) {
        if (global_ns() - start > kMaxWaitNs) __trap();
      }
    }
    __syncwarp();
    float* sb = sums + buf * w;
    pool_rows(a.partials + pc.pair * a.parts * w, a.parts, w, a.tag, sb, lane);
    __syncwarp();
    if (pc.part == 0) {
      for (int j = lane; j < w; j += 32) {
        a.img_sums[(pc.img * 2 + j / a.cs) * cg + pc.j0 + j % a.cs] = sb[j];
      }
    }
    bar_arrive(kBarReady + buf, all);
  }
}

// grid: one block per SM, all resident (a cooperative launch); block: rows *
// nv compute threads, then the producer, publisher and waiter warps. The
// ring holds ring_steps steps of an x and a dy tile, each rows pixels of a
// slice's ne elements in pixel order, with a full and an empty mbarrier a
// slot, and a piece's steps all fit it. Compute thread t takes vector t of
// each tile: column t % nv (VEC channels) of pixel row t / nv.
template <typename T, int VEC, bool SHFL>
__global__ void __launch_bounds__(kBwdThreads + 96, 1) in_bwd_fused_kernel(const BwdArgs<T> a) {
  using V = Vec<T, VEC>;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  const int tc = a.rows * a.nv;  // compute threads; the role warps follow
  const int all = tc + 32;       // the compute threads and one role warp
  const int ne = a.nv * VEC;     // elements of a slice's pixel: group * cs
  // red holds, per buffer, a warp's sums over its rows and the q blocks (cs
  // floats of each sum) with SHFL, else a pixel row's (ne floats).
  const int groups = SHFL ? tc / 32 : a.rows;
  const int width = SHFL ? a.cs : ne;
  uint64_t* full = reinterpret_cast<uint64_t*>(bwd_smem);  // kMaxRingSteps
  uint64_t* empty = full + kMaxRingSteps;                   // kMaxRingSteps
  V* ring = reinterpret_cast<V*>(empty + kMaxRingSteps);
  float* red = reinterpret_cast<float*>(ring + static_cast<size_t>(a.ring_steps) * 2 * tc);
  // Per buffer, the pair's Σdpre, Σ(dpre * xhat) of the piece being applied:
  // 2 * cs floats.
  float* sums = red + kBuffers * 2 * groups * width;
  const long long pieces = a.b * a.nslices * a.parts;
  const long long m = (pieces - 1 - blockIdx.x) / gridDim.x + 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.ring_steps; ++s) {
      mbar_init(smem_u32(full + s), 32);
      mbar_init(smem_u32(empty + s), tc / 32);
    }
  }
  __syncthreads();
  if (threadIdx.x >= tc) {
    if (threadIdx.x < tc + 32) {
      bwd_producer<T, VEC, SHFL>(a, m, ring, full, empty, tc);
    } else if (threadIdx.x < tc + 64) {
      bwd_publisher(a, m, red, groups, width, SHFL ? 1 : a.group, all);
    } else {
      bwd_waiter(a, m, sums, all);
    }
    return;
  }
  const int t = threadIdx.x;
  const int r0 = t / a.nv;       // this thread's pixel row of a step
  const int e0 = t % a.nv * VEC;  // its first element of a slice's pixel
  const int cg = a.c / a.group;
  const int col = e0 / a.cs * cg + e0 % a.cs;  // its channel, less the slice's j0
  const int oc0 = e0 % a.cs;                   // its original channel, less j0

  auto piece = [&](long long i) {
    return piece_of(a, static_cast<int>(blockIdx.x + i * gridDim.x));
  };
  // This thread's vector of the x tile (dy: + tc) of ring slot `slot`.
  auto tile = [&](int slot) { return ring + static_cast<size_t>(slot) * 2 * tc + t; };
  // This thread's parameters of a piece: mean and rstd of its VEC channels of
  // the image, scale and bias of their original channels (contiguous: a
  // slice's cs is a multiple of VEC, or the whole pixel with VEC = 1).
  auto params = [&](const Piece& pc, float (&pm)[VEC], float (&pr)[VEC], float (&ps)[VEC],
                    float (&pb)[VEC]) {
    load_floats<VEC>(a.mean + pc.img * a.c + pc.j0 + col, pm);
    load_floats<VEC>(a.rstd + pc.img * a.c + pc.j0 + col, pr);
    load_floats<VEC>(a.scale + pc.j0 + oc0, ps);
    load_floats<VEC>(a.bias + pc.j0 + oc0, pb);
  };
  const float inv_n = 1.f / a.n;
  // The element offset of this thread's vector in a piece's first step, and
  // from one step to the next.
  auto first = [&](const Piece& pc) { return (pc.img * a.hw + pc.p0 + r0) * a.c + pc.j0 + col; };
  const long long sstride = static_cast<long long>(a.rows) * a.c;

  // Σdpre and Σ(dpre * xhat) of one piece (its first ring step `cur`): each
  // thread's over its pixels, then (butterflies over the lanes of a channel's
  // pixel rows and q blocks, when W divides the warp) one entry per warp or
  // pixel row into red buffer `buf`, for the publisher.
  auto reduce = [&](const Piece& pc, Cursor cur, int buf) {
    float pm[VEC], pr[VEC], ps[VEC], pb[VEC];
    params(pc, pm, pr, ps, pb);
    float s1[VEC], s2[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) { s1[k] = 0.f; s2[k] = 0.f; }
    long long p = pc.p0 + r0;
    for (int k = 0; k < pc.steps; ++k, p += a.rows) {
      mbar_wait(smem_u32(full + cur.slot), cur.parity);
      const V* e = tile(cur.slot);
      cur.next(a.ring_steps);
      if (p >= pc.p1) continue;
      const V xv = e[0];
      const V gv = e[tc];
#pragma unroll
      for (int k2 = 0; k2 < VEC; ++k2) {
        float xhat, dpre;
        bwd_terms(to_f32(xv.v[k2]), to_f32(gv.v[k2]), pm[k2], pr[k2], ps[k2], pb[k2], a.slope,
                  xhat, dpre);
        s1[k2] += dpre;
        s2[k2] += dpre * xhat;
      }
    }
    float* rb = red + buf * 2 * groups * width;
    if constexpr (SHFL) {
      // Over the warp's pixel rows (lanes nv apart), then its q blocks (lanes
      // cs / VEC apart): lane l < cs / VEC ends with channels l * VEC...
      for (int o = a.cs / VEC; o < 32; o <<= 1) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          s1[k] += __shfl_xor_sync(0xFFFFFFFFu, s1[k], o);
          s2[k] += __shfl_xor_sync(0xFFFFFFFFu, s2[k], o);
        }
      }
      if ((t & 31) < a.cs / VEC) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          rb[(t >> 5) * width + e0 + k] = s1[k];
          rb[(groups + (t >> 5)) * width + e0 + k] = s2[k];
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        rb[r0 * width + e0 + k] = s1[k];
        rb[(groups + r0) * width + e0 + k] = s2[k];
      }
    }
    bar_arrive(kBarRows + buf, all);
  };

  // dx of one piece (its first ring slot `slot`), once the waiter has added
  // the pair's rows into stage buffer `buf`, each warp handing each step's
  // slot back to the producer.
  auto apply = [&](const Piece& pc, int slot, int buf) {
    float pm[VEC], pr[VEC], ps[VEC], pb[VEC], m1[VEC], m2[VEC];
    params(pc, pm, pr, ps, pb);
    bar_sync(kBarReady + buf, all);
    // m1 = scale * Σdpre / n and m2 = scale * Σ(dpre * xhat) / n per channel.
    const float* sb = sums + buf * 2 * a.cs;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      m1[k] = __fmul_rn(__fmul_rn(ps[k], sb[oc0 + k]), inv_n);
      m2[k] = __fmul_rn(__fmul_rn(ps[k], sb[a.cs + oc0 + k]), inv_n);
    }
    long long p = pc.p0 + r0;
    long long off = first(pc);
    for (int k = 0; k < pc.steps; ++k, p += a.rows, off += sstride) {
      const V* e = tile(slot);
      if (p < pc.p1) {
        store_vec<T, VEC>(a.dx + off, input_grad<T, VEC>(e[0], e[tc], pm, pr, ps, pb, m1, m2,
                                                        a.slope));
      }
      __syncwarp();
      if ((t & 31) == 0) mbar_arrive(smem_u32(empty + slot));
      if (++slot == a.ring_steps) slot = 0;
    }
  };

  // Up to kLookahead pieces after piece i are reduced (their rows handed to
  // the publisher) before piece i is applied, as long as the ring keeps room
  // for kLoadingSteps more steps to be loading meanwhile.
  Cursor rcur;
  long long reduced = 0, applied_steps = 0;
  int aslot = 0;
  for (long long i = 0; i < m; ++i) {
    while (reduced <= i + kLookahead && reduced < m) {
      const Piece pc = piece(reduced);
      if (reduced > i && rcur.n + pc.steps + kLoadingSteps - applied_steps > a.ring_steps) break;
      reduce(pc, rcur, static_cast<int>(reduced % kBuffers));
      for (int k = 0; k < pc.steps; ++k) rcur.next(a.ring_steps);
      ++reduced;
    }
    const Piece pc = piece(i);
    apply(pc, aslot, static_cast<int>(i % kBuffers));
    aslot = (aslot + pc.steps) % a.ring_steps;
    applied_steps += pc.steps;
  }
}

// Dynamic shared memory a kernel may take without an opt-in.
constexpr size_t kSmemLimit = 48 * 1024;

// The shared memory of the statistics and backward-reduce kernels: the row
// sums, and pool_partials' room after them.
size_t reduce_smem(const Tiling& t, int c, int group) {
  const size_t rows = static_cast<size_t>(2) * t.rows * c;
  const size_t pool = pool_floats(t.threads, c / group);
  return (rows > pool ? rows : pool) * sizeof(float);
}

template <typename T, int VEC, bool FINALIZE>
cudaError_t launch_stats(const T* x, float* partials, float* mean, float* rstd, unsigned* count,
                         long long b, long long hw, int c, int group, int chunk_px, int nchunk,
                         float eps, cudaStream_t stream) {
  const Tiling t = tiling<VEC>(c);
  const size_t smem = reduce_smem(t, c, group);
  if (t.threads > 1024 || smem > kSmemLimit) return cudaErrorInvalidValue;
  in_stats_kernel<T, VEC, FINALIZE>
      <<<dim3(nchunk, static_cast<unsigned>(b)), t.threads, smem, stream>>>(
          x, partials, mean, rstd, count, hw, c, group, chunk_px, nchunk,
          static_cast<float>(hw * group), eps);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_apply(const T* x, T* y, const float* mean, const float* rstd,
                         const float* scale, const float* bias, long long b, long long hw, int c,
                         int group, int chunk_px, int nchunk, float slope, cudaStream_t stream) {
  const Tiling t = tiling<VEC>(c);
  if (t.threads > 1024) return cudaErrorInvalidValue;
  in_apply_kernel<T, VEC><<<dim3(nchunk, static_cast<unsigned>(b)), t.threads, 0, stream>>>(
      x, y, mean, rstd, scale, bias, hw, c, group, chunk_px, slope);
  return cudaGetLastError();
}

template <typename T, bool FINALIZE>
cudaError_t stats(const void* xv, float* partials, float* mean, float* rstd, unsigned* count,
                  long long b, long long hw, int c, int group, int chunk_px, int nchunk,
                  float eps, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  constexpr int kWide = 16 / sizeof(T);
  return vec_width<T>(c, xv, xv) == kWide
      ? launch_stats<T, kWide, FINALIZE>(x, partials, mean, rstd, count, b, hw, c, group,
                                         chunk_px, nchunk, eps, stream)
      : launch_stats<T, 1, FINALIZE>(x, partials, mean, rstd, count, b, hw, c, group, chunk_px,
                                     nchunk, eps, stream);
}

template <typename T>
cudaError_t apply(const void* xv, void* yv, const float* mean, const float* rstd,
                  const float* scale, const float* bias, long long b, long long hw, int c,
                  int group, int chunk_px, int nchunk, float slope, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  constexpr int kWide = 16 / sizeof(T);
  return vec_width<T>(c, xv, yv) == kWide
      ? launch_apply<T, kWide>(x, y, mean, rstd, scale, bias, b, hw, c, group, chunk_px, nchunk,
                               slope, stream)
      : launch_apply<T, 1>(x, y, mean, rstd, scale, bias, b, hw, c, group, chunk_px, nchunk,
                           slope, stream);
}


// Floats of the backward's shared memory besides the ring: the ring's full
// and empty mbarriers, kBuffers red buffers of the block's sums (an entry of
// cs floats per compute warp with SHFL, else of ne per pixel row), and
// kBuffers stage buffers of the pairs' sums (kernels/instance_norm.py::bwd_plan).
inline int bwd_scratch_floats(int tc, int rows, int ne, int cs, bool shfl) {
  const int groups = shfl ? tc / 32 : rows;
  return 4 * kMaxRingSteps + kBuffers * 2 * groups * (shfl ? cs : ne) + kBuffers * 2 * cs;
}

// A kernel's launch limits on one device, set up at its first launch there:
// the SMs, the dynamic shared memory a block may take (its opt-in is raised
// to that), and the blocks an SM holds at the most threads and shared memory
// a plan asks for.
struct LaunchLimits {
  int sms = 0, smem = 0, per_sm = 0;
};
constexpr int kMaxDevices = 64;

template <typename T, int VEC, bool SHFL>
cudaError_t launch_limits(LaunchLimits& out) {
  static LaunchLimits cache[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  LaunchLimits& lim = cache[dev];
  if (lim.per_sm == 0) {
    const void* kernel = reinterpret_cast<const void*>(in_bwd_fused_kernel<T, VEC, SHFL>);
    cudaFuncAttributes attr;
    int optin = 0;
    LaunchLimits found;
    err = cudaDeviceGetAttribute(&found.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    found.smem = optin - static_cast<int>(attr.sharedSizeBytes);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, found.smem);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&found.per_sm, kernel,
                                                          kBwdThreads + 96, found.smem);
    }
    if (err != cudaSuccess) return err;
    if (found.per_sm == 0) return cudaErrorCooperativeLaunchTooLarge;
    lim = found;
  }
  out = lim;
  return cudaSuccess;
}

template <typename T, int VEC, bool SHFL>
cudaError_t launch_bwd_fused(BwdArgs<T> a, float* dscale, float* dbias, int grid,
                             cudaStream_t stream) {
  const int tc = a.rows * a.nv;
  const size_t smem = static_cast<size_t>(a.ring_steps) * 2 * tc * sizeof(Vec<T, VEC>) +
                      sizeof(float) * bwd_scratch_floats(tc, a.rows, a.nv * VEC, a.cs, SHFL);
  if (tc > kBwdThreads || tc % 32 != 0) return cudaErrorInvalidValue;
  LaunchLimits lim;
  cudaError_t err = launch_limits<T, VEC, SHFL>(lim);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(lim.smem)) return cudaErrorInvalidValue;
  if (static_cast<long long>(lim.per_sm) * lim.sms < grid) {
    return cudaErrorCooperativeLaunchTooLarge;
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(in_bwd_fused_kernel<T, VEC, SHFL>),
                                    dim3(grid), dim3(tc + 96), args, smem, stream);
  if (err != cudaSuccess) return err;
  const int cg = a.c / a.group;
  in_bwd_params_kernel<<<(cg + 255) / 256, 256, 0, stream>>>(a.img_sums, dscale, dbias, a.b, cg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_fused(BwdArgs<T> a, int vec, float* dscale, float* dbias, int grid,
                      cudaStream_t stream) {
  constexpr int kWide = 16 / sizeof(T);
  // SHFL: a warp's lanes of one column are nv apart and those of one
  // channel's q blocks cs / vec apart, both powers of 2.
  const bool shfl = 32 % a.nv == 0 && a.cs % vec == 0;
  if (vec == kWide) {
    return shfl ? launch_bwd_fused<T, kWide, true>(a, dscale, dbias, grid, stream)
                : launch_bwd_fused<T, kWide, false>(a, dscale, dbias, grid, stream);
  }
  return shfl ? launch_bwd_fused<T, 1, true>(a, dscale, dbias, grid, stream)
              : launch_bwd_fused<T, 1, false>(a, dscale, dbias, grid, stream);
}

// `passes`: 1 the reduce (and dscale, dbias from this call's own sums), 2 the
// apply on the img_sums already in place with the pixel count `n`, 3 both.
template <typename T, int VEC>
cudaError_t launch_two_pass(const T* x, const T* dy, const float* mean, const float* rstd,
                            const float* scale, const float* bias, float* partials,
                            float* img_sums, unsigned* count, T* dx, float* dscale, float* dbias,
                            long long b, long long hw, int c, int group, int chunk_px,
                            int nchunk, float n, float slope, int passes, cudaStream_t stream) {
  const Tiling t = tiling<VEC>(c);
  const int cg = c / group;
  const size_t smem = reduce_smem(t, c, group);
  if (t.threads > 1024 || smem > kSmemLimit) return cudaErrorInvalidValue;
  const dim3 grid(nchunk, static_cast<unsigned>(b));
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
    in_bwd_reduce_kernel<T, VEC><<<grid, t.threads, smem, stream>>>(
        x, dy, mean, rstd, scale, bias, partials, img_sums, count, hw, c, group, chunk_px,
        nchunk, slope);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (passes & 2) {
    in_bwd_apply_kernel<T, VEC><<<grid, t.threads, 0, stream>>>(
        x, dy, mean, rstd, scale, bias, img_sums, dx, hw, c, group, chunk_px, n, slope);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (passes & 1) {
    in_bwd_params_kernel<<<(cg + 255) / 256, 256, 0, stream>>>(img_sums, dscale, dbias, b, cg);
    err = cudaGetLastError();
  }
  return err;
}

template <typename T>
cudaError_t bwd_two_pass(const void* xv, const void* dyv, const float* mean, const float* rstd,
                         const float* scale, const float* bias, float* partials, float* img_sums,
                         unsigned* count, void* dxv, float* dscale, float* dbias, long long b,
                         long long hw, int c, int group, int chunk_px, int nchunk, float n,
                         float slope, int passes, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* dy = static_cast<const T*>(dyv);
  T* dx = static_cast<T*>(dxv);
  constexpr int kWide = 16 / sizeof(T);
  // The reduce alone writes no dx: its pointer may be null.
  const void* out = (passes & 2) ? dxv : xv;
  const bool wide = vec_width<T>(c, xv, out) == kWide && vec_width<T>(c, dyv, dyv) == kWide;
  return wide
      ? launch_two_pass<T, kWide>(x, dy, mean, rstd, scale, bias, partials, img_sums, count, dx,
                                  dscale, dbias, b, hw, c, group, chunk_px, nchunk, n, slope,
                                  passes, stream)
      : launch_two_pass<T, 1>(x, dy, mean, rstd, scale, bias, partials, img_sums, count, dx,
                              dscale, dbias, b, hw, c, group, chunk_px, nchunk, n, slope, passes,
                              stream);
}

}  // namespace

cudaError_t in_stats(const void* x, int dtype, float* partials, long long b, long long hw, int c,
                     int chunk_px, int nchunk, cudaStream_t stream) {
  switch (dtype) {
    case kFloat32:
      return stats<float, false>(x, partials, nullptr, nullptr, nullptr, b, hw, c, 1, chunk_px,
                                 nchunk, 0.f, stream);
    case kBFloat16:
      return stats<__nv_bfloat16, false>(x, partials, nullptr, nullptr, nullptr, b, hw, c, 1,
                                         chunk_px, nchunk, 0.f, stream);
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
  const long long elem = dtype == kFloat32 ? 4 : 2;
  long long chunk = (hw + kMaxChunks - 1) / kMaxChunks;
  const long long min_chunk = kMinChunkBytes / (c * elem);
  if (chunk < min_chunk) chunk = min_chunk;
  if (chunk > hw) chunk = hw;
  if (chunk < 1) chunk = 1;
  const int nchunk = static_cast<int>((hw + chunk - 1) / chunk);
  switch (dtype) {
    case kFloat32:
      return apply<float>(x, y, mean, rstd, scale, bias, b, hw, c, group,
                          static_cast<int>(chunk), nchunk, slope, stream);
    case kBFloat16:
      return apply<__nv_bfloat16>(x, y, mean, rstd, scale, bias, b, hw, c, group,
                                  static_cast<int>(chunk), nchunk, slope, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace unet

namespace {

bool bad_geometry(long long b, long long hw, int c, int group, int chunk_px, int nchunk) {
  return b <= 0 || b > 65535 || hw <= 0 || c <= 0 || group <= 0 || c % group != 0 ||
         nchunk <= 0 || chunk_px <= 0 || static_cast<long long>(chunk_px) * nchunk < hw ||
         static_cast<long long>(chunk_px) * (nchunk - 1) >= hw;
}

}  // namespace

// The forward. x, y: (B, H*W, C) contiguous, float32 or bfloat16 (`dtype`,
// see common.cuh). scale, bias: (C / group,) float32. Scratch: partials (B,
// nchunk, 2, C) float32, count (B,) uint32 (zeroed here). Outputs mean, rstd:
// (B, C) float32. Each block covers chunk_px pixels of an image, nchunk
// blocks an image. `passes`: 1 the statistics pass, 2 the apply pass (on the
// mean and rstd an earlier statistics pass left), 3 both.
extern "C" int unet_instance_norm_fwd(const void* x, void* y, const void* scale,
                                      const void* bias, void* partials, void* count, void* mean,
                                      void* rstd, int dtype, long long b, long long hw, int c,
                                      int group, int chunk_px, int nchunk, float eps,
                                      float slope, int passes, void* stream) {
  if (bad_geometry(b, hw, c, group, chunk_px, nchunk) || passes < 1 || passes > 3) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto pa = static_cast<float*>(partials);
  auto cn = static_cast<unsigned*>(count);
  auto me = static_cast<float*>(mean);
  auto rs = static_cast<float*>(rstd);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  if (passes & 1) {
    cudaError_t err = cudaMemsetAsync(cn, 0, b * sizeof(unsigned), s);
    if (err != cudaSuccess) return err;
    switch (dtype) {
      case unet::kFloat32:
        err = unet::stats<float, true>(x, pa, me, rs, cn, b, hw, c, group, chunk_px, nchunk, eps,
                                       s);
        break;
      case unet::kBFloat16:
        err = unet::stats<__nv_bfloat16, true>(x, pa, me, rs, cn, b, hw, c, group, chunk_px,
                                               nchunk, eps, s);
        break;
      default:
        return cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return err;
  }
  if (!(passes & 2)) return cudaSuccess;
  switch (dtype) {
    case unet::kFloat32:
      return unet::apply<float>(x, y, me, rs, sc, bi, b, hw, c, group, chunk_px, nchunk, slope,
                                s);
    case unet::kBFloat16:
      return unet::apply<__nv_bfloat16>(x, y, me, rs, sc, bi, b, hw, c, group, chunk_px, nchunk,
                                        slope, s);
    default:
      return cudaErrorInvalidValue;
  }
}

namespace {

// What the backward's entry point refuses: a plan (kernels/instance_norm.py::
// bwd_plan) that does not cover the image once, or that the kernel's layout
// cannot take.
bool bad_bwd_plan(long long b, long long hw, int c, int group, int itemsize, int vec, int cs,
                  int parts, int part_px, int rows, int ring_steps, int grid,
                  const void* x, const void* dy, const void* dx) {
  if (b <= 0 || hw <= 0 || c <= 0 || group <= 0 || c % group != 0) return true;
  const int cg = c / group;
  if (cs <= 0 || cg % cs != 0) return true;
  const int wide = 16 / itemsize;  // elements a 16-byte vector
  if (vec == wide) {
    const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
    if (c % wide != 0 || cs % wide != 0) return true;
    if (misaligned(x) || misaligned(dy) || misaligned(dx)) return true;
  } else if (vec != 1) {
    return true;
  }
  const int nv = group * cs / vec;
  if (rows <= 0 || static_cast<long long>(rows) * nv > unet::kBwdThreads || rows * nv % 32 != 0) {
    return true;
  }
  const long long px = part_px;
  if (parts <= 0 || px <= 0 || px * parts < hw || px * (parts - 1) >= hw) return true;
  const long long steps = (px + rows - 1) / rows;
  if (ring_steps <= 0 || ring_steps > unet::kMaxRingSteps || steps > ring_steps) return true;
  const long long pieces = b * (cg / cs) * parts;  // indexed in 32 bits
  return pieces >= (1ll << 31) || grid <= 0 || grid > pieces;
}

template <typename T>
cudaError_t bwd(const void* x, const void* dy, const void* mean, const void* rstd,
                const void* scale, const void* bias, void* partials, void* img_sums, void* count,
                void* dx, void* dscale, void* dbias, long long b, long long hw, int c, int group,
                int vec,
                int cs, int parts, int part_px, int rows, int ring_steps, int grid,
                unsigned tag, float slope, cudaStream_t stream) {
  const int cg = c / group;
  const unet::BwdArgs<T> a{static_cast<const T*>(x), static_cast<const T*>(dy),
                           static_cast<const float*>(mean), static_cast<const float*>(rstd),
                           static_cast<const float*>(scale), static_cast<const float*>(bias),
                           static_cast<unsigned long long*>(partials),
                           static_cast<float*>(img_sums), static_cast<unsigned*>(count),
                           static_cast<T*>(dx), b, hw, c, group,
                           cs, cg / cs, group * cs / vec, rows, parts, part_px, ring_steps,
                           tag, static_cast<float>(hw * group), slope};
  const cudaError_t err = cudaMemsetAsync(count, 0, b * (cg / cs) * sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  return unet::bwd_fused<T>(a, vec, static_cast<float*>(dscale), static_cast<float*>(dbias),
                            grid, stream);
}

}  // namespace

// The backward. x, dy, dx: (B, H*W, C) contiguous, in `dtype`. mean, rstd:
// (B, C) float32 from the forward; scale, bias: (C / group,) float32. The
// plan (kernels/instance_norm.py::bwd_plan): `vec` elements a vector, `cs`
// original channels a slice, `parts` pieces of `part_px` pixels a pair,
// `rows` pixel rows a step, a ring of `ring_steps` steps that holds a whole
// piece, `grid` blocks. Scratch: partials (B * C/group/cs * parts * 2 * cs)
// 64-bit words, which hold no word tagged `tag` (nonzero) before the call,
// img_sums (B, 2, C / group) float32 and count (B * C/group/cs,) uint32
// (zeroed here). Outputs dscale, dbias: (C / group,) float32. A launch the card refuses (shared memory, a cooperative grid
// larger than the card holds) returns its error.
extern "C" int unet_instance_norm_bwd(const void* x, const void* dy, const void* mean,
                                      const void* rstd, const void* scale, const void* bias,
                                      void* partials, void* img_sums, void* count, void* dx,
                                      void* dscale, void* dbias, int dtype, long long b,
                                      long long hw, int c,
                                      int group, int vec, int cs, int parts, int part_px,
                                      int rows, int ring_steps, int grid, unsigned tag,
                                      float slope, void* stream) {
  const int itemsize = dtype == unet::kFloat32 ? 4 : dtype == unet::kBFloat16 ? 2 : 0;
  if (itemsize == 0 || tag == 0 ||
      bad_bwd_plan(b, hw, c, group, itemsize, vec, cs, parts, part_px, rows, ring_steps,
                   grid, x, dy, dx)) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  return dtype == unet::kFloat32
      ? bwd<float>(x, dy, mean, rstd, scale, bias, partials, img_sums, count, dx, dscale, dbias,
                   b, hw, c, group, vec, cs, parts, part_px, rows, ring_steps, grid, tag,
                   slope, s)
      : bwd<__nv_bfloat16>(x, dy, mean, rstd, scale, bias, partials, img_sums, count, dx,
                           dscale, dbias, b, hw, c, group, vec, cs, parts, part_px, rows,
                           ring_steps, grid, tag, slope, s);
}

// The two-pass backward, for the shapes whose (image, slice) pairs need every
// block (kernels/instance_norm.py::bwd_plan), and for every shape when an
// image's rows are spread over several processes: x, dy, dx, mean, rstd,
// scale, bias as above. Scratch: partials (B, nchunk, 2, C) and img_sums (B,
// 2, C / group) float32, count (B,) uint32 (zeroed here). Each block covers
// chunk_px pixels of an image, nchunk blocks an image (chunking, as the
// forward). `passes`: 1 the reduce, which leaves the image's Σdpre and
// Σ(dpre * xhat) in img_sums and writes dscale and dbias from them; 2 the
// apply, which writes dx from the img_sums in place (another process's sums
// may have been added to them in between) with `n` values a channel pools;
// 3 both, with n = H * W * group.
extern "C" int unet_instance_norm_bwd_two_pass(const void* x, const void* dy, const void* mean,
                                               const void* rstd, const void* scale,
                                               const void* bias, void* partials, void* img_sums,
                                               void* count, void* dx, void* dscale, void* dbias,
                                               int dtype, long long b, long long hw, int c,
                                               int group, int chunk_px, int nchunk, float n,
                                               float slope, int passes, void* stream) {
  if (bad_geometry(b, hw, c, group, chunk_px, nchunk) || passes < 1 || passes > 3 ||
      !(n > 0.f)) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto me = static_cast<const float*>(mean);
  auto rs = static_cast<const float*>(rstd);
  auto sc = static_cast<const float*>(scale);
  auto bi = static_cast<const float*>(bias);
  auto pa = static_cast<float*>(partials);
  auto is = static_cast<float*>(img_sums);
  auto cn = static_cast<unsigned*>(count);
  auto ds = static_cast<float*>(dscale);
  auto db = static_cast<float*>(dbias);
  if (passes & 1) {
    const cudaError_t err = cudaMemsetAsync(cn, 0, b * sizeof(unsigned), s);
    if (err != cudaSuccess) return err;
  }
  switch (dtype) {
    case unet::kFloat32:
      return unet::bwd_two_pass<float>(x, dy, me, rs, sc, bi, pa, is, cn, dx, ds, db, b, hw, c,
                                       group, chunk_px, nchunk, n, slope, passes, s);
    case unet::kBFloat16:
      return unet::bwd_two_pass<__nv_bfloat16>(x, dy, me, rs, sc, bi, pa, is, cn, dx, ds, db, b,
                                               hw, c, group, chunk_px, nchunk, n, slope, passes,
                                               s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The forward's statistics pass without its finalize, for an image whose rows
// are spread over several processes: partials (B, nchunk, 2, C) float32 of
// this process's rows, which the caller adds up over the processes before
// unet_instance_norm_finalize. x as in the forward.
extern "C" int unet_instance_norm_partials(const void* x, void* partials, int dtype, long long b,
                                           long long hw, int c, int chunk_px, int nchunk,
                                           void* stream) {
  if (bad_geometry(b, hw, c, 1, chunk_px, nchunk)) return cudaErrorInvalidValue;
  return unet::in_stats(x, dtype, static_cast<float*>(partials), b, hw, c, chunk_px, nchunk,
                        static_cast<cudaStream_t>(stream));
}

// mean and rstd (B, C) float32 from partials (B, nchunk, 2, C) summed over
// the processes, each original channel pooling its `group` q blocks and `n`
// values in all (the whole image's H * W * group). The forward's apply pass
// (unet_instance_norm_fwd, passes 2) then runs on them.
extern "C" int unet_instance_norm_finalize(const void* partials, void* mean, void* rstd,
                                           long long b, int nchunk, int c, int group, float n,
                                           float eps, void* stream) {
  if (b <= 0 || b > 65535 || nchunk <= 0 || c <= 0 || group <= 0 || c % group != 0 ||
      !(n > 0.f)) {
    return cudaErrorInvalidValue;
  }
  return unet::in_finalize(static_cast<const float*>(partials), static_cast<float*>(mean),
                           static_cast<float*>(rstd), b, nchunk, c, group, n, eps,
                           static_cast<cudaStream_t>(stream));
}
