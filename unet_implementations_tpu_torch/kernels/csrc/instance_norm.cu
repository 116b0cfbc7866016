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
// whole pass over an image before any output of it can be written, so each
// direction reads its inputs twice. Both passes tile (image, chunk of pixels):
// a thread keeps the same VEC channels for the whole block (threads of a pixel
// row read neighbouring 16-byte vectors, the block's rows stride over the
// chunk), so its per-channel parameters sit in registers, and it keeps
// kUnroll 16-byte loads of each input in flight. The TPU version carried its
// sums in VMEM across a sequential grid; Hopper's blocks run in no order, so
// each block of the first pass writes float32 partial sums, and the last block
// to finish an image (an atomic count per image, after a __threadfence) adds
// that image's partials in a fixed order, once. No atomic touches a sum, so
// runs repeat bit for bit. The second pass walks the blocks in reverse, so it
// starts on the images the first pass read last, which are still in the 50 MB
// L2.
//
// Forward, two launches:
//   1. in_stats_kernel: per (image, chunk, channel) partials of x and x*x; an
//      image's last block turns them into its mean and rstd.
//   2. in_apply_kernel: normalize and activate.
// Backward (dx in x's dtype, dscale and dbias float32), three launches:
//   1. in_bwd_reduce_kernel: recomputes xhat = (x - mean) * rstd and the
//      pre-activation xhat * scale + bias with the forward's roundings, so each
//      element takes the slope the forward gave it; dpre = dy * lrelu'(pre);
//      partials of dpre and dpre * xhat; an image's last block adds them into
//      the image's Σdpre and Σ(dpre * xhat) per original channel.
//   2. in_bwd_apply_kernel: m1 = scale * Σdpre / n and m2 = scale *
//      Σ(dpre * xhat) / n, then dx = rstd * (dpre * scale - m1 - xhat * m2)
//      in the plain version's order, rounded once.
//   3. in_bwd_params_kernel: dbias = Σdpre and dscale = Σ(dpre * xhat) over
//      the images, in order.
// The plain version sums dxhat = dpre * scale, rounded per element; the
// factored m1, m2 differ from it by float32 rounding only.
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
// is recomputed with the forward's roundings.
__device__ __forceinline__ void bwd_terms(float xv, float dyv, float m, float r, float s, float bi,
                                          float slope, float& xhat, float& dpre) {
  xhat = __fmul_rn(__fsub_rn(xv, m), r);
  const float pre = __fadd_rn(__fmul_rn(xhat, s), bi);
  dpre = pre >= 0.f ? dyv : __fmul_rn(dyv, slope);
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

// grid (nchunk, B): partials of dpre and dpre * xhat per (image, chunk,
// channel); an image's last block stores the image's Σdpre and Σ(dpre * xhat)
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

template <typename T, int VEC>
cudaError_t launch_bwd(const T* x, const T* dy, const float* mean, const float* rstd,
                       const float* scale, const float* bias, float* partials, float* img_sums,
                       unsigned* count, T* dx, float* dscale, float* dbias, long long b,
                       long long hw, int c, int group, int chunk_px, int nchunk, float slope,
                       cudaStream_t stream) {
  const Tiling t = tiling<VEC>(c);
  const int cg = c / group;
  const size_t smem = reduce_smem(t, c, group);
  if (t.threads > 1024 || smem > kSmemLimit) return cudaErrorInvalidValue;
  const dim3 grid(nchunk, static_cast<unsigned>(b));
  in_bwd_reduce_kernel<T, VEC><<<grid, t.threads, smem, stream>>>(
      x, dy, mean, rstd, scale, bias, partials, img_sums, count, hw, c, group, chunk_px, nchunk,
      slope);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_bwd_apply_kernel<T, VEC><<<grid, t.threads, 0, stream>>>(
      x, dy, mean, rstd, scale, bias, img_sums, dx, hw, c, group, chunk_px,
      static_cast<float>(hw * group), slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  in_bwd_params_kernel<<<(cg + 255) / 256, 256, 0, stream>>>(img_sums, dscale, dbias, b, cg);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd(const void* xv, const void* dyv, const float* mean, const float* rstd,
                const float* scale, const float* bias, float* partials, float* img_sums,
                unsigned* count, void* dxv, float* dscale, float* dbias, long long b,
                long long hw, int c, int group, int chunk_px, int nchunk, float slope,
                cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* dy = static_cast<const T*>(dyv);
  T* dx = static_cast<T*>(dxv);
  constexpr int kWide = 16 / sizeof(T);
  const bool wide = vec_width<T>(c, xv, dxv) == kWide && vec_width<T>(c, dyv, dyv) == kWide;
  return wide
      ? launch_bwd<T, kWide>(x, dy, mean, rstd, scale, bias, partials, img_sums, count, dx,
                             dscale, dbias, b, hw, c, group, chunk_px, nchunk, slope, stream)
      : launch_bwd<T, 1>(x, dy, mean, rstd, scale, bias, partials, img_sums, count, dx, dscale,
                         dbias, b, hw, c, group, chunk_px, nchunk, slope, stream);
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

// The backward. x, dy, dx: (B, H*W, C) contiguous, in `dtype`. mean, rstd:
// (B, C) float32 from the forward; scale, bias: (C / group,) float32.
// Scratch: partials (B, nchunk, 2, C) and img_sums (B, 2, C / group) float32,
// count (B,) uint32 (zeroed here). Outputs dscale, dbias: (C / group,) float32.
extern "C" int unet_instance_norm_bwd(const void* x, const void* dy, const void* mean,
                                      const void* rstd, const void* scale, const void* bias,
                                      void* partials, void* img_sums, void* count, void* dx,
                                      void* dscale, void* dbias, int dtype, long long b,
                                      long long hw, int c, int group, int chunk_px, int nchunk,
                                      float slope, void* stream) {
  if (bad_geometry(b, hw, c, group, chunk_px, nchunk)) return cudaErrorInvalidValue;
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
  const cudaError_t err = cudaMemsetAsync(cn, 0, b * sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  switch (dtype) {
    case unet::kFloat32:
      return unet::bwd<float>(x, dy, me, rs, sc, bi, pa, is, cn, dx, ds, db, b, hw, c, group,
                              chunk_px, nchunk, slope, s);
    case unet::kBFloat16:
      return unet::bwd<__nv_bfloat16>(x, dy, me, rs, sc, bi, pa, is, cn, dx, ds, db, b, hw, c,
                                      group, chunk_px, nchunk, slope, s);
    default:
      return cudaErrorInvalidValue;
  }
}
