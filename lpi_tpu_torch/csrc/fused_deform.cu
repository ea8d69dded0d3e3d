// Sample-first fused deformable 3x3 conv for the VLDyHead
// (`deform_impl="fused"`), forward and backward, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of `lpi_tpu/ops/fused_deform_kernel.py`:
//   * `fused_deform` forward (`_fused_fwd_kernel`, `_sample_tap`);
//   * its custom VJP (`_fused_vjp_bwd`, `_fused_bwd_kernel`).
//
// What it computes, per output pixel p = (b, y, x), tap k = (ky, kx) =
// (k / kw, k % kw), stride S (1 or 2), offsets clamped to [-m, m] by the
// caller, zero outside the map:
//
//   samp_k[p, c] = sum_{dy,dx in [-m, m+1]} g_k hat(oy_k, dy) hat(ox_k, dx)
//                  * f[b, S*y + ky - 1 + dy, S*x + kx - 1 + dx, c]
//   out[p, n]    = sum_k sum_c samp_k[p, c] * W[k, c, n]
//
// with hat(o, d) = max(0, 1 - |o - d|), f [B, H, W, C], oy/ox/g [B, K, Ho, Wo],
// W [K, C, Cout], all fp32, and fp32 accumulation. As in `deform_window.cu`,
// only floor(o) and floor(o) + 1 carry weight per axis, so each sample reads
// the 4 bilinear corners straight from the UNPADDED map (the TPU kernel reads
// a padded copy): the weights use the hat sum's own float expression, the
// window [-m, m+1] and the map's bounds are tested, and the nonzero terms are
// added in the hat sum's order (dy, then dx ascending).
//
// The TPU kernel carries its fp32 output across a sequential channel-tile
// grid axis and culls displacements per image; neither carries over. Here:
//
// Forward (`lpi_fused_deform_fwd`, one launch): one block owns 64 output
// pixels x 64 output channels. For each tap it computes the 64 pixels' corner
// weights and addresses once into shared memory; then, for each chunk of 32
// feature channels, it samples the [64 x 32] slab into shared memory, loads
// the W_k chunk [32 x 64], and 256 threads accumulate a register-tiled 4 x 4
// fp32 product each. The product samp_k @ W_k is this kernel's, in fp32 FMAs
// (no tensor cores: TF32 keeps about three digits).
//
// Backward (`lpi_fused_deform_bwd`, up to four launches, one call):
//   1. U[p, k, c] = sum_n ct[p, n] W[k, c, n], the per-tap cotangent in
//      feature space (the TPU kernel's u_k = ct @ W_k^T): a tiled fp32
//      product into a scratch U [B*Ho*Wo, K*C] that the caller allocates.
//   2. One launch with two kinds of blocks:
//      * d f as a GATHER, no atomics: one thread owns VEC channels of one
//        input pixel and, for each tap, visits the output pixels that can
//        reach it (8 x 8 at stride 1, 4 x 4 at stride 2), adding
//        g * hat * hat * U where the weight is nonzero. d f is written once.
//      * d oy, d ox, d g: one warp per (output pixel, tap); lanes stride over
//        C, form the four corner dot products s = sum_c U[p,k,c] f[corner,c],
//        and one shuffle sum per output gives
//          doy = sum g dhat(oy, dy) hat(ox, dx) s,  dox likewise,
//          dg  = sum hat(oy, dy) hat(ox, dx) s,
//        with dhat(o, d) = -sign(o - d) where |o - d| < 1, else 0 (the Pallas
//        `_dhat`: 0 at integer offsets). Corners are skipped only outside
//        |o - d| < 1, the window and the map, never on the gate.
//   3. (when d W is asked for) d W[k, c, n] = sum_p samp_k[p, c] ct[p, n]:
//      each block re-samples its tap for one range of pixels and writes a
//      partial [64 x 64] tile; the TPU kernel carries d W across its
//      sequential batch axis, which Hopper blocks cannot do.
//   4. (with 3) a second pass sums the partial tiles in a fixed order. No
//      fp32 atomics anywhere, so runs repeat bit for bit.
//
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s fp32 outside the tensor cores): by
// operations. At P3 of the 448 px train step (4 x 56 x 56 output pixels, C =
// Cout = 256, K = 9) the forward does 2 K C Cout = 1.18 MFLOP per pixel, 14.8
// GFLOP, about 0.22 ms at the fp32 rate, against about 10 MB of bytes (3 us).
// The backward's U product is as many operations again and d W as many once
// more. This design is a simple 4 x 4 register tile without double buffering;
// tensor cores (TF32 or bf16 wgmma, with their own tolerance) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 tile each
constexpr int kTP = 64;        // output pixels per block (rows of the product)
constexpr int kTN = 64;        // output channels per block (columns)
constexpr int kTC = 32;        // feature channels per chunk (forward)
constexpr int kTR = 32;        // reduction chunk of the U product
constexpr int kTQ = 16;        // pixels per step of the d W product
constexpr int kWarps = kThreads / 32;
// the loaders below fill a [kTP] and a [kTN] tile side in one loop
static_assert(kTP == kTN, "tile sides must match");

// Corner weights g * hat * hat (0 where a corner is skipped) and pixel
// indices (b * H + iy) * W + ix of output pixel p, tap k: the forward's rule.
__device__ __forceinline__ void corners(const float* __restrict__ oy,
                                        const float* __restrict__ ox,
                                        const float* __restrict__ gate, long long p,
                                        long long npix, int k, int H, int W, int Ho,
                                        int Wo, int K, int kw, int m, int S, float (&cw)[4],
                                        int (&ci)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    cw[q] = 0.f;
    ci[q] = 0;
  }
  if (p >= npix) return;
  const int xo = (int)(p % Wo);
  const long long rest = p / Wo;
  const int yo = (int)(rest % Ho);
  const long long b = rest / Ho;
  const long long oidx = (b * K + k) * Ho * Wo + (long long)yo * Wo + xo;
  const float o_y = __ldg(oy + oidx), o_x = __ldg(ox + oidx), g = __ldg(gate + oidx);
  const float lo = (float)(-m), hi = (float)(m + 1);
  const float fy = floorf(o_y), fx = floorf(o_x);
  const int by = S * yo + k / kw - 1;
  const int bx = S * xo + k % kw - 1;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float dy = fy + (float)a;
    const int iy = by + (int)dy;
    if (dy < lo || dy > hi || iy < 0 || iy >= H) continue;
    const float gwy = g * fmaxf(0.f, 1.f - fabsf(o_y - dy));
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) {
      const float dx = fx + (float)bb;
      const int ix = bx + (int)dx;
      if (dx < lo || dx > hi || ix < 0 || ix >= W) continue;
      const float c = gwy * fmaxf(0.f, 1.f - fabsf(o_x - dx));
      if (c == 0.f) continue;
      cw[a * 2 + bb] = c;
      ci[a * 2 + bb] = (int)((b * H + iy) * W + ix);
    }
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
fused_fwd_kernel(const float* __restrict__ f, const float* __restrict__ oy,
                 const float* __restrict__ ox, const float* __restrict__ gate,
                 const float* __restrict__ w, float* __restrict__ out, int H, int W, int C,
                 int Ho, int Wo, int K, int kw, int Cout, int m, int S, long long npix) {
  __shared__ float s_samp[kTC][kTP + 1];  // sampled slab, channel-major
  __shared__ float s_w[kTC][kTN];         // W_k chunk
  __shared__ float s_cw[4][kTP];
  __shared__ int s_ci[4][kTP];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long p0 = (long long)blockIdx.x * kTP;
  const int n0 = blockIdx.y * kTN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    if (tid < kTP) {
      float cw[4];
      int ci[4];
      corners(oy, ox, gate, p0 + tid, npix, k, H, W, Ho, Wo, K, kw, m, S, cw, ci);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s_cw[q][tid] = cw[q];
        s_ci[q][tid] = ci[q];
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < C; c0 += kTC) {
#pragma unroll
      for (int i = 0; i < kTP * kTC / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int c = e % kTC, p = e / kTC;
        float v = 0.f;
        if (c0 + c < C) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float cwq = s_cw[q][p];
            if (cwq != 0.f) v += cwq * __ldg(f + (long long)s_ci[q][p] * C + c0 + c);
          }
        }
        s_samp[c][p] = v;
      }
#pragma unroll
      for (int i = 0; i < kTC * kTN / kThreads; ++i) {
        const int e = tid + i * kThreads;
        const int n = e % kTN, c = e / kTN;
        s_w[c][n] = (c0 + c < C && n0 + n < Cout)
                        ? __ldg(w + ((long long)k * C + c0 + c) * Cout + n0 + n)
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kTC; ++c) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_samp[c][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = s_w[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bv[j];
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = p0 + ty + 16 * i;
    if (p >= npix) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout) out[p * Cout + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// backward 1: U = ct @ W2^T, W2 = W viewed as [K*C, Cout]
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
u_product_kernel(const float* __restrict__ ct, const float* __restrict__ w,
                 float* __restrict__ u, long long M, int N, int R) {
  __shared__ float s_a[kTR][kTP + 1];  // ct tile, [r][p]
  __shared__ float s_b[kTR][kTN + 1];  // W2 tile, [r][j]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long p0 = (long long)blockIdx.x * kTP;
  const int j0 = blockIdx.y * kTN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int r0 = 0; r0 < R; r0 += kTR) {
#pragma unroll
    for (int i = 0; i < kTP * kTR / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int r = e % kTR, row = e / kTR;
      const long long p = p0 + row;
      s_a[r][row] = (p < M && r0 + r < R) ? __ldg(ct + p * R + r0 + r) : 0.f;
      const int j = j0 + row;
      s_b[r][row] = (j < N && r0 + r < R) ? __ldg(w + (long long)j * R + r0 + r) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kTR; ++r) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_a[r][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s_b[r][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long p = p0 + ty + 16 * i;
    if (p >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = j0 + tx + 16 * j;
      if (n < N) u[p * N + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// backward 2: d f gather and the offset / gate gradients
// ---------------------------------------------------------------------------

template <int VEC>
__device__ __forceinline__ void load4(const float* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
  }
}

__device__ __forceinline__ int floor_div(int a, int s) {
  return a >= 0 ? a / s : -((-a + s - 1) / s);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Thread t owns VEC channels of one input pixel.
template <int VEC>
__device__ __forceinline__ void df_gather(const float* __restrict__ oy,
                                          const float* __restrict__ ox,
                                          const float* __restrict__ gate,
                                          const float* __restrict__ u, float* __restrict__ df,
                                          int H, int W, int C, int Ho, int Wo, int K, int kw,
                                          int m, int S, long long t, long long total) {
  if (t >= total) return;
  const int groups = C / VEC;
  const int c0 = (int)(t % groups) * VEC;
  const long long pix = t / groups;
  const int ix = (int)(pix % W);
  const long long rest = pix / W;
  const int iy = (int)(rest % H);
  const long long b = rest / H;
  const long long plane = (long long)Ho * Wo;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  for (int k = 0; k < K; ++k) {
    const int ky = k / kw, kx = k % kw;
    const float* oyk = oy + (b * K + k) * plane;
    const float* oxk = ox + (b * K + k) * plane;
    const float* gk = gate + (b * K + k) * plane;
    // output rows whose displacement dy = iy - S*y - ky + 1 lies in [-m, m+1]
    const int ylo = max(0, -floor_div(-(iy - ky - m), S));
    const int yhi = min(Ho - 1, floor_div(iy - ky + 1 + m, S));
    const int xlo = max(0, -floor_div(-(ix - kx - m), S));
    const int xhi = min(Wo - 1, floor_div(ix - kx + 1 + m, S));
    for (int y = ylo; y <= yhi; ++y) {
      const float dy = (float)(iy - S * y - ky + 1);
      for (int x = xlo; x <= xhi; ++x) {
        const long long o = (long long)y * Wo + x;
        const float wy = fmaxf(0.f, 1.f - fabsf(__ldg(oyk + o) - dy));
        if (wy == 0.f) continue;
        const float dx = (float)(ix - S * x - kx + 1);
        const float wx = fmaxf(0.f, 1.f - fabsf(__ldg(oxk + o) - dx));
        if (wx == 0.f) continue;
        const float cf = __ldg(gk + o) * wy * wx;
        if (cf == 0.f) continue;
        float v[VEC];
        load4<VEC>(u + ((b * plane + o) * K + k) * C + c0, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += cf * v[i];
      }
    }
  }
  float* dst = df + pix * C + c0;
#pragma unroll
  for (int i = 0; i < VEC; ++i) dst[i] = acc[i];
}

// One warp per (output pixel, tap) item.
template <int VEC>
__device__ __forceinline__ void offset_grads(const float* __restrict__ f,
                                             const float* __restrict__ oy,
                                             const float* __restrict__ ox,
                                             const float* __restrict__ gate,
                                             const float* __restrict__ u,
                                             float* __restrict__ doy, float* __restrict__ dox,
                                             float* __restrict__ dgate, int H, int W, int C,
                                             int Ho, int Wo, int K, int kw, int m, int S,
                                             long long item, long long n_items, int lane) {
  if (item >= n_items) return;  // uniform across the warp
  const int k = (int)(item % K);
  const long long pix = item / K;
  const int xo = (int)(pix % Wo);
  const long long rest = pix / Wo;
  const int yo = (int)(rest % Ho);
  const long long b = rest / Ho;
  const long long plane = (long long)Ho * Wo;
  const long long oidx = (b * K + k) * plane + (long long)yo * Wo + xo;
  const float o_y = __ldg(oy + oidx), o_x = __ldg(ox + oidx), g = __ldg(gate + oidx);
  const float lo = (float)(-m), hi = (float)(m + 1);
  const int by = S * yo + k / kw - 1;
  const int bx = S * xo + k % kw - 1;

  float wy[2], dwy[2], wx[2], dwx[2];
  long long ry[2], rx[2];
  bool vy[2], vx[2];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float dy = floorf(o_y) + (float)a;
    const float ty = o_y - dy;
    const int iy = by + (int)dy;
    ry[a] = iy;
    vy[a] = dy >= lo && dy <= hi && iy >= 0 && iy < H && fabsf(ty) < 1.f;
    wy[a] = fmaxf(0.f, 1.f - fabsf(ty));
    dwy[a] = ty > 0.f ? -1.f : (ty < 0.f ? 1.f : 0.f);
    const float dx = floorf(o_x) + (float)a;
    const float tx = o_x - dx;
    const int ix = bx + (int)dx;
    rx[a] = ix;
    vx[a] = dx >= lo && dx <= hi && ix >= 0 && ix < W && fabsf(tx) < 1.f;
    wx[a] = fmaxf(0.f, 1.f - fabsf(tx));
    dwx[a] = tx > 0.f ? -1.f : (tx < 0.f ? 1.f : 0.f);
  }

  const float* fb = f + b * H * W * C;
  const float* up = u + (pix * K + k) * C;
  float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int c = lane * VEC; c < C; c += 32 * VEC) {
    float uv[VEC];
    load4<VEC>(up + c, uv);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      if (!vy[a]) continue;
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        if (!vx[bb]) continue;
        float fv[VEC];
        load4<VEC>(fb + (ry[a] * W + rx[bb]) * C + c, fv);
        float pdot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) pdot += uv[i] * fv[i];
        s[a][bb] += pdot;
      }
    }
  }
  float pdy = 0.f, pdx = 0.f, pdg = 0.f;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) {
      if (!(vy[a] && vx[bb])) continue;
      pdy += g * dwy[a] * wx[bb] * s[a][bb];
      pdx += g * wy[a] * dwx[bb] * s[a][bb];
      pdg += wy[a] * wx[bb] * s[a][bb];
    }
  }
  pdy = warp_sum(pdy);
  pdx = warp_sum(pdx);
  pdg = warp_sum(pdg);
  if (lane == 0) {
    doy[oidx] = pdy;
    dox[oidx] = pdx;
    dgate[oidx] = pdg;
  }
}

// Blocks [0, df_blocks) gather d f; the rest compute d oy, d ox and d gate.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
fused_bwd_sample_kernel(const float* __restrict__ f, const float* __restrict__ oy,
                        const float* __restrict__ ox, const float* __restrict__ gate,
                        const float* __restrict__ u, float* __restrict__ df,
                        float* __restrict__ doy, float* __restrict__ dox,
                        float* __restrict__ dgate, int B, int H, int W, int C, int Ho, int Wo,
                        int K, int kw, int m, int S, long long df_blocks) {
  if ((long long)blockIdx.x < df_blocks) {
    const long long total = (long long)B * H * W * (C / VEC);
    df_gather<VEC>(oy, ox, gate, u, df, H, W, C, Ho, Wo, K, kw, m, S,
                   (long long)blockIdx.x * kThreads + threadIdx.x, total);
  } else {
    const long long n_items = (long long)B * Ho * Wo * K;
    const long long item = ((long long)blockIdx.x - df_blocks) * kWarps + threadIdx.x / 32;
    offset_grads<VEC>(f, oy, ox, gate, u, doy, dox, dgate, H, W, C, Ho, Wo, K, kw, m, S, item,
                      n_items, threadIdx.x % 32);
  }
}

// ---------------------------------------------------------------------------
// backward 3 and 4: d W, per-block partial tiles and their fixed-order sum
// ---------------------------------------------------------------------------

// grid (ceil(C/64) * ceil(Cout/64), K, splits): tile (c0, n0) of tap k over
// the split's range of output pixels -> partial[split, k, c, n].
__global__ void __launch_bounds__(kThreads)
dw_partial_kernel(const float* __restrict__ f, const float* __restrict__ oy,
                  const float* __restrict__ ox, const float* __restrict__ gate,
                  const float* __restrict__ ct, float* __restrict__ partial, int H, int W,
                  int C, int Ho, int Wo, int K, int kw, int Cout, int m, int S, long long npix,
                  long long per_split) {
  __shared__ float s_s[kTQ][kTP];  // samples [p][c]
  __shared__ float s_ct[kTQ][kTN];
  __shared__ float s_cw[4][kTQ];
  __shared__ int s_ci[4][kTQ];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n_tiles = (Cout + kTN - 1) / kTN;
  const int c0 = (blockIdx.x / n_tiles) * kTP;
  const int n0 = (blockIdx.x % n_tiles) * kTN;
  const int k = blockIdx.y;
  const long long pstart = (long long)blockIdx.z * per_split;
  const long long pend = min(npix, pstart + per_split);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long q0 = pstart; q0 < pend; q0 += kTQ) {
    if (tid < kTQ) {
      float cw[4];
      int ci[4];
      corners(oy, ox, gate, q0 + tid, pend, k, H, W, Ho, Wo, K, kw, m, S, cw, ci);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s_cw[q][tid] = cw[q];
        s_ci[q][tid] = ci[q];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTQ * kTP / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int c = e % kTP, p = e / kTP;
      float v = 0.f;
      if (c0 + c < C) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float cwq = s_cw[q][p];
          if (cwq != 0.f) v += cwq * __ldg(f + (long long)s_ci[q][p] * C + c0 + c);
        }
      }
      s_s[p][c] = v;
      const int n = e % kTN;
      const long long pp = q0 + p;
      s_ct[p][n] = (pp < pend && n0 + n < Cout) ? __ldg(ct + pp * Cout + n0 + n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kTQ; ++p) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_s[p][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s_ct[p][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }
  float* dst = partial + ((long long)blockIdx.z * K + k) * C * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty + 16 * i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Cout) dst[(long long)c * Cout + n] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dw_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw, long long n,
              int splits) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += __ldg(partial + s * n + e);
  dw[e] = v;
}

bool bad_dims(int B, int H, int W, int C, int Ho, int Wo, int K, int kw, int Cout, int m,
              int stride) {
  return B <= 0 || H <= 0 || W <= 0 || C <= 0 || Ho <= 0 || Wo <= 0 || K <= 0 || kw <= 0 ||
         K % kw != 0 || Cout <= 0 || m < 0 || (stride != 1 && stride != 2) ||
         Ho != (H + stride - 1) / stride || Wo != (W + stride - 1) / stride ||
         (long long)B * H * W > 2147483647LL;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream`, does
// not synchronise and allocates nothing; it returns cudaGetLastError() after
// its launches (or cudaErrorInvalidValue for arguments it does not take).

// f [B, H, W, C], oy/ox/gate [B, K, Ho, Wo], w [K, C, Cout] -> out [B, Ho, Wo,
// Cout], all fp32 and contiguous.
extern "C" int lpi_fused_deform_fwd(const void* f, const void* oy, const void* ox,
                                    const void* gate, const void* w, void* out, int B, int H,
                                    int W, int C, int Ho, int Wo, int K, int kw, int Cout, int m,
                                    int stride, void* stream) {
  if (bad_dims(B, H, W, C, Ho, Wo, K, kw, Cout, m, stride)) return (int)cudaErrorInvalidValue;
  const long long npix = (long long)B * Ho * Wo;
  const long long gx = (npix + kTP - 1) / kTP;
  const int gy = (Cout + kTN - 1) / kTN;
  if (gx > 2147483647LL || gy > 65535) return (int)cudaErrorInvalidConfiguration;
  fused_fwd_kernel<<<dim3((unsigned)gx, gy), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(oy), static_cast<const float*>(ox),
      static_cast<const float*>(gate), static_cast<const float*>(w), static_cast<float*>(out), H,
      W, C, Ho, Wo, K, kw, Cout, m, stride, npix);
  return (int)cudaGetLastError();
}

// Backward of `lpi_fused_deform_fwd` for the cotangent ct [B, Ho, Wo, Cout]:
// df [B, H, W, C], doy/dox/dgate [B, K, Ho, Wo], and, when dw is not null,
// dw [K, C, Cout]. Scratch from the caller: u [B*Ho*Wo, K*C] and, with dw,
// partial [splits, K, C, Cout]. Every output element is written. `vec` (4 or
// 1) is the channel group of the gather and the warps; 4 needs C % 4 == 0
// and 16-byte aligned f and u.
extern "C" int lpi_fused_deform_bwd(const void* f, const void* oy, const void* ox,
                                    const void* gate, const void* w, const void* ct, void* u,
                                    void* df, void* doy, void* dox, void* dgate, void* partial,
                                    void* dw, int B, int H, int W, int C, int Ho, int Wo, int K,
                                    int kw, int Cout, int m, int stride, int splits, int vec,
                                    void* stream) {
  if (bad_dims(B, H, W, C, Ho, Wo, K, kw, Cout, m, stride) || (vec != 1 && vec != 4) ||
      C % vec != 0 || splits <= 0 || splits > 65535 || (dw != nullptr && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ff = static_cast<const float*>(f);
  const float* fy = static_cast<const float*>(oy);
  const float* fx = static_cast<const float*>(ox);
  const float* fg = static_cast<const float*>(gate);
  const float* fw = static_cast<const float*>(w);
  const float* fc = static_cast<const float*>(ct);
  float* fu = static_cast<float*>(u);
  const long long npix = (long long)B * Ho * Wo;

  const long long ux = (npix + kTP - 1) / kTP;
  const int uy = (K * C + kTN - 1) / kTN;
  if (ux > 2147483647LL || uy > 65535) return (int)cudaErrorInvalidConfiguration;
  u_product_kernel<<<dim3((unsigned)ux, uy), kThreads, 0, s>>>(fc, fw, fu, npix, K * C, Cout);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long df_blocks = ((long long)B * H * W * (C / vec) + kThreads - 1) / kThreads;
  const long long off_blocks = (npix * K + kWarps - 1) / kWarps;
  if (df_blocks + off_blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const unsigned nb = (unsigned)(df_blocks + off_blocks);
  if (vec == 4)
    fused_bwd_sample_kernel<4><<<nb, kThreads, 0, s>>>(
        ff, fy, fx, fg, fu, static_cast<float*>(df), static_cast<float*>(doy),
        static_cast<float*>(dox), static_cast<float*>(dgate), B, H, W, C, Ho, Wo, K, kw, m,
        stride, df_blocks);
  else
    fused_bwd_sample_kernel<1><<<nb, kThreads, 0, s>>>(
        ff, fy, fx, fg, fu, static_cast<float*>(df), static_cast<float*>(doy),
        static_cast<float*>(dox), static_cast<float*>(dgate), B, H, W, C, Ho, Wo, K, kw, m,
        stride, df_blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess || dw == nullptr) return (int)err;

  const long long per_split = (npix + splits - 1) / splits;
  const int tiles = ((C + kTP - 1) / kTP) * ((Cout + kTN - 1) / kTN);
  if (K > 65535) return (int)cudaErrorInvalidConfiguration;
  dw_partial_kernel<<<dim3(tiles, K, splits), kThreads, 0, s>>>(
      ff, fy, fx, fg, fc, static_cast<float*>(partial), H, W, C, Ho, Wo, K, kw, Cout, m, stride,
      npix, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)K * C * Cout;
  dw_sum_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), n, splits);
  return (int)cudaGetLastError();
}
