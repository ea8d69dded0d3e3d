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
// grid axis and culls displacements per image; neither carries over.
//
// Forward (`lpi_fused_deform_fwd`, one launch). A block owns a tile of TP
// output pixels x TN output channels. It first stages the tile's offsets
// and gate for every tap in shared memory (one coalesced pass), and per tap
// builds the corner table (four weights and pixel rows per pixel) from
// them. Then, per tap, it samples the tile's slab of up to 256 feature
// channels ONCE into shared memory ([TP][C + 4]; each thread issues the
// 16-byte corner loads of four elements before it adds any), while W_k
// streams by `cp.async` through a ring of four chunks of [TC x TN] (three
// in flight while one is multiplied; one barrier per chunk). Each thread
// adds its RP x RN outputs' terms with fp32 fused multiply-adds in the first
// design's order, tap by tap and channel by channel, reading four channels
// of each of its pixels and four output channels at a time as 16-byte
// shared loads. The tile follows the shape (`pick_tile`): the largest of
// 64 x 128 (256 threads of 4 x 8 outputs, TC 16), 32 x 128 (128 of 4 x 8,
// TC 32) and 16 x 64 (128 of 2 x 4, TC 64) that gives at least one block
// per SM (132), else the smallest. So the large maps sample each tap once
// per 128 output channels (the first design sampled once per 64), and the
// small maps get 4x-8x the blocks that 64 x 64 gave them and a quarter of
// the barriers.
//
// Backward (`lpi_fused_deform_bwd`, up to four launches, one call):
//   1. U[p, k, c] = sum_n ct[p, n] W[k, c, n], the per-tap cotangent in
//      feature space (the TPU kernel's u_k = ct @ W_k^T), into a scratch U
//      [B*Ho*Wo, K*C] that the caller allocates: the forward's product
//      engine with both operands read along the reduction (ct rows and W's
//      [K*C, Cout] rows, by `cp.async` into a ring of 3 or 4 chunks of 32
//      or 64), the same tiles and rule over (pixels, K*C).
//   2. One launch with two kinds of blocks:
//      * d f as a GATHER, no atomics, by strips (the design of the window
//        backward's `dh_strip` in `deform_window.cu`): one warp owns a strip
//        of four vertically neighbouring input pixels and 32 x VEC channels.
//        For each tap, the lanes test the output pixels whose window can
//        reach the strip (11 x 8 at stride 1, 6 x 4 at stride 2), one
//        candidate a lane, and a ballot gives the hits in (y, x) order; the
//        warp then adds g * hat * hat * U of each hit to the channels of
//        each pixel it reaches. d f is written once. (The first design
//        repeated every candidate's test, a dependent offset load each, in
//        each thread of VEC channels.)
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
//      sequential batch axis, which Hopper blocks cannot do. The number of
//      ranges is `lpi_fused_deform_dw_splits`, fixed by the shape alone.
//   4. (with 3) a second pass sums the partial tiles in a fixed order. No
//      fp32 atomics anywhere, so runs repeat bit for bit.
//
// Bits. Every output element takes the same nonzero terms as in the first
// design of this file, in the same order, each with one fused multiply-add: the
// forward's and U's sums run tap by tap and channel by channel, and d f's
// hits come in (tap, y, x) order. So the outputs equal the first design's
// bit for bit, and the quality gate's values do not move.
//
// Bound on an H100 (3.35 TB/s; 67 TFLOP/s fp32 outside the tensor cores): by
// operations. At P3 of the 448 px train step (4 x 56 x 56 output pixels, C =
// Cout = 256, K = 9) the forward does 2 K C Cout = 1.18 MFLOP per pixel, 14.8
// GFLOP, about 0.22 ms at the fp32 rate, against about 10 MB of bytes (3 us).
// The backward's U product is as many operations again and d W as many once
// more. The products stay on the fp32 FMA units: TF32 alone misses the 1e-5
// bar, a split TF32 product on the tensor cores (hi hi + hi lo + lo hi,
// `mma.sync` m16n8k8) missed it too, by up to 2.2x, and either would change
// the bits.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; `scripts/torch_fused_compare.py`
// beside the first design, PERF.md): per 448 px train step (batch 4, 78
// calls) the forward 11.7 ms against 26.5 (bound 2.69, 23%) and the
// backward without d W 9.2 ms against 25.3 (bound 2.73, 30%); at P3 the
// forward 0.66 ms (34% of its bound); the maps of 14^2 and less take about
// 0.066 ms a forward, the shared loads' latency and the nine taps' sampling
// round trips, not the operations, setting the time there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads of the d f, offset and d W blocks
constexpr int kWarps = kThreads / 32;
constexpr int kSMs = 132;      // H100 SXM: the tile rule's block count, fixed
constexpr int kSlabC = 256;    // feature channels of one sampled slab, at most
constexpr int kPad = 4;        // row padding of shared tiles read along the reduction
constexpr int kStrip = 4;      // input pixels of one d f warp, one above the other
constexpr int kMaxSmem = 232448;  // shared memory a block may have (bytes)
constexpr int kSampleBatch = 4;   // slab elements a thread samples with all loads in flight
constexpr unsigned kFull = 0xffffffffu;
// the d W pass (first design): a 64 x 64 tile of (c, n), 16 pixels a step
constexpr int kTP = 64;
constexpr int kTN = 64;
constexpr int kTQ = 16;
static_assert(kTP == kTN, "tile sides must match");

__host__ __device__ constexpr int round_up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

// Corner weights g * hat * hat (0 where a corner is skipped) and pixel
// indices (b * H + iy) * W + ix of output pixel (b, yo, xo), tap k, at
// offsets (o_y, o_x) and gate g: the forward's rule.
__device__ __forceinline__ void corners_of(float o_y, float o_x, float g, long long b, int yo,
                                           int xo, int k, int H, int W, int kw, int m, int S,
                                           float (&cw)[4], int (&ci)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    cw[q] = 0.f;
    ci[q] = 0;
  }
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

// The same for output pixel p < npix (else no corner), offsets and gate
// read from [B, K, Ho, Wo].
__device__ __forceinline__ void corners(const float* __restrict__ oy,
                                        const float* __restrict__ ox,
                                        const float* __restrict__ gate, long long p,
                                        long long npix, int k, int H, int W, int Ho,
                                        int Wo, int K, int kw, int m, int S, float (&cw)[4],
                                        int (&ci)[4]) {
  const int xo = (int)(p % Wo);
  const long long rest = p / Wo;
  const int yo = (int)(rest % Ho);
  const long long b = rest / Ho;
  const long long oidx = (b * K + k) * Ho * Wo + (long long)yo * Wo + xo;
  const bool in = p < npix;
  corners_of(in ? __ldg(oy + oidx) : 0.f, in ? __ldg(ox + oidx) : 0.f,
             in ? __ldg(gate + oidx) : 0.f, b, yo, xo, k, H, W, kw, m, S, cw, ci);
}

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

// 16 (or 4) bytes from global to shared memory by `cp.async` where `ok`,
// else zeros stored at once (seen by the other threads after the barrier
// that follows the wait); the copies issued since the last `copy_commit`
// form one group, and `copy_wait<N>` waits until at most the N latest
// groups are in flight.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  if (ok)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src)
                 : "memory");
  else
    *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  if (ok)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                 "l"(src)
                 : "memory");
  else
    *dst = 0.f;
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tile of the forward and of U, TP rows (pixels) x TN columns: the
// largest that gives at least kSMs blocks over rows x cols, else the
// smallest. A tile of TP x TN runs NT threads of RP x RN outputs each
// (`tile_threads`, TP = NT / 16 * RP, TN = 16 RN).
struct Tile {
  int tp, tn;
};

Tile pick_tile(long long rows, long long cols) {
  const Tile tiles[] = {{64, 128}, {32, 128}, {16, 64}};
  for (const Tile& t : tiles) {
    if ((rows + t.tp - 1) / t.tp * ((cols + t.tn - 1) / t.tn) >= kSMs) return t;
  }
  return tiles[2];
}

// The reduction chunk (channels between two barriers) and the depth of the
// ring of chunks in flight, per tile of TP rows: the smaller tiles take
// larger chunks, so that a chunk holds work enough to cover its barrier.
constexpr int kFwdStages = 4;
template <int TP>
__host__ __device__ constexpr int fwd_chunk() { return TP == 64 ? 16 : (TP == 32 ? 32 : 64); }
template <int TP>
__host__ __device__ constexpr int u_chunk() { return TP == 16 ? 64 : 32; }
template <int TP>
__host__ __device__ constexpr int u_stages() { return TP == 64 ? 3 : 4; }

// One thread's RP x RN outputs: pixels (rows) RP*ty + i; columns 4 tx + j and
// (RN == 8) 64 + 4 tx + j, j < 4.
__device__ __forceinline__ int col_of(int tx, int j) {
  return (j < 4 ? 0 : 64) + 4 * tx + (j & 3);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// Shared memory of the forward, in floats: the ring of W_k chunks
// [NST][TC][TN], the slab [TP][slab_c + kPad], the tile's offsets and gate
// [3][K][TP], and one tap's corner table, weights [4][TP] and rows [4][TP].
__host__ __device__ inline int fwd_slab_c(int C, int TC) { return imin(round_up(C, TC), kSlabC); }

__host__ __device__ inline long long fwd_smem_floats(int TP, int TN, int NST, int TC, int C,
                                                    int K) {
  return (long long)NST * TC * TN + (long long)TP * (fwd_slab_c(C, TC) + kPad) + 3LL * K * TP +
         8LL * TP;
}

template <int RP, int RN, int NT, int VEC>
__global__ void __launch_bounds__(NT, 2)
fused_fwd_kernel(const float* __restrict__ f, const float* __restrict__ oy,
                 const float* __restrict__ ox, const float* __restrict__ gate,
                 const float* __restrict__ w, float* __restrict__ out, int H, int W, int C,
                 int Ho, int Wo, int K, int kw, int Cout, int m, int S, long long npix,
                 int wvec, int ovec) {
  constexpr int TP = NT / 16 * RP, TN = 16 * RN, TC = fwd_chunk<TP>(), NST = kFwdStages;
  extern __shared__ __align__(16) float smem[];
  const int slab_c = fwd_slab_c(C, TC);
  const int srow = slab_c + kPad;
  float* s_w = smem;                     // [NST][TC][TN]
  float* s_slab = s_w + NST * TC * TN;   // [TP][srow]
  float* s_off = s_slab + TP * srow;      // [3][K][TP]: oy, ox, gate
  float* s_cw = s_off + 3 * K * TP;       // [4][TP]
  int* s_ci = reinterpret_cast<int*>(s_cw + 4 * TP);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long p0 = (long long)blockIdx.x * TP;
  const int n0 = blockIdx.y * TN;
  const int nch = round_up(C, TC) / TC;  // W_k chunks per tap
  const int cps = slab_c / TC;           // chunks per slab
  const int T = K * nch;
  const long long plane = (long long)Ho * Wo;

  // the W_k chunk of step t into its slot of the ring (an empty group past
  // the last step keeps the count of groups in flight)
  auto issue = [&](int t) {
    if (t < T) {
      const int k = t / nch, c0 = (t % nch) * TC;
      float* dst = s_w + (t % NST) * TC * TN;
      const float* wk = w + ((long long)k * C + c0) * Cout + n0;
      if (wvec) {
        for (int e = tid; e < TC * TN / 4; e += NT) {
          const int c = e / (TN / 4), n = (e % (TN / 4)) * 4;
          copy16(dst + c * TN + n, wk + (long long)c * Cout + n, c0 + c < C && n0 + n < Cout);
        }
      } else {
        for (int e = tid; e < TC * TN; e += NT) {
          const int c = e / TN, n = e % TN;
          copy4(dst + c * TN + n, wk + (long long)c * Cout + n, c0 + c < C && n0 + n < Cout);
        }
      }
    }
    copy_commit();
  };

  for (int t = 0; t < NST - 1; ++t) issue(t);
  // the tile's offsets and gate for every tap, one coalesced pass
  for (int e = tid; e < K * TP; e += NT) {
    const int k = e / TP;
    const long long q = p0 + e % TP;
    float vy = 0.f, vx = 0.f, vg = 0.f;
    if (q < npix) {
      const long long oidx = (q / plane * K + k) * plane + q % plane;
      vy = __ldg(oy + oidx);
      vx = __ldg(ox + oidx);
      vg = __ldg(gate + oidx);
    }
    s_off[e] = vy;
    s_off[K * TP + e] = vx;
    s_off[2 * K * TP + e] = vg;
  }

  float acc[RP][RN];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < T; ++t) {
    const int k = t / nch, j = t % nch;
    if (j % cps == 0) {
      // a new slab: channels [cs0, cs0 + nc) of tap k, sampled once
      __syncthreads();  // the offsets are in; the last slab and table no longer read
      if (j == 0) {  // tap k's corner table
        for (int p = tid; p < TP; p += NT) {
          const long long q = p0 + p;
          const long long r = q % plane;
          float cw[4];
          int ci[4];
          corners_of(s_off[k * TP + p], s_off[(K + k) * TP + p], s_off[(2 * K + k) * TP + p],
                     q / plane, (int)(r / Wo), (int)(r % Wo), k, H, W, kw, m, S, cw, ci);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s_cw[c * TP + p] = cw[c];
            s_ci[c * TP + p] = ci[c];
          }
        }
        __syncthreads();
      }
      // kSampleBatch elements a thread at a time: all their corners' loads
      // are issued before any is used (a corner of weight 0 reads pixel row
      // 0 and is not added)
      const int cs0 = j * TC;
      const int groups = imin(slab_c, round_up(C, TC) - cs0) / VEC;
      for (int e0 = tid; e0 < TP * groups; e0 += kSampleBatch * NT) {
        float cw[kSampleBatch][4], fv[kSampleBatch][4][VEC];
#pragma unroll
        for (int u = 0; u < kSampleBatch; ++u) {
          const int e = e0 + u * NT;
          const int p = e / groups, c = cs0 + (e % groups) * VEC;
          const bool in = e < TP * groups && c < C;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            cw[u][q] = in ? s_cw[q * TP + p] : 0.f;
            if (in) {
              load4<VEC>(f + (long long)s_ci[q * TP + p] * C + c, fv[u][q]);
            } else {
#pragma unroll
              for (int i = 0; i < VEC; ++i) fv[u][q][i] = 0.f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kSampleBatch; ++u) {
          const int e = e0 + u * NT;
          if (e >= TP * groups) break;
          const int p = e / groups, c = cs0 + (e % groups) * VEC;
          float v[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[i] = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (cw[u][q] != 0.f)
#pragma unroll
              for (int i = 0; i < VEC; ++i) v[i] = fmaf(cw[u][q], fv[u][q][i], v[i]);
          float* dst = s_slab + p * srow + (c - cs0);
          if constexpr (VEC == 4) {
            *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
            dst[0] = v[0];
          }
        }
      }
    }
    copy_wait<NST - 2>();
    __syncthreads();  // chunk t (and the slab) visible; chunk t - 1 no longer read
    issue(t + NST - 1);

    const float* sw = s_w + (t % NST) * TC * TN;
    const float* sa = s_slab + (RP * ty) * srow + (j % cps) * TC;
#pragma unroll
    for (int c4 = 0; c4 < TC; c4 += 4) {
      float a[RP][4];
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const float4 q = *reinterpret_cast<const float4*>(sa + i * srow + c4);
        a[i][0] = q.x; a[i][1] = q.y; a[i][2] = q.z; a[i][3] = q.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float bv[RN];
#pragma unroll
        for (int h = 0; h < RN / 4; ++h) {
          const float4 q =
              *reinterpret_cast<const float4*>(sw + (c4 + cc) * TN + col_of(tx, 4 * h));
          bv[4 * h] = q.x; bv[4 * h + 1] = q.y; bv[4 * h + 2] = q.z; bv[4 * h + 3] = q.w;
        }
#pragma unroll
        for (int i = 0; i < RP; ++i)
#pragma unroll
          for (int jj = 0; jj < RN; ++jj) acc[i][jj] = fmaf(a[i][cc], bv[jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const long long p = p0 + RP * ty + i;
    if (p >= npix) continue;
    float* row = out + p * Cout;
#pragma unroll
    for (int h = 0; h < RN / 4; ++h) {
      const int n = n0 + col_of(tx, 4 * h);
      if (ovec && n < Cout) {
        *reinterpret_cast<float4*>(row + n) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (n + jj < Cout) row[n + jj] = acc[i][4 * h + jj];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward 1: U = ct @ W2^T, W2 = W viewed as [K*C, Cout]
// ---------------------------------------------------------------------------

// U [M, N] = ct [M, R] . W2 [N, R]^T: both operands are rows along the
// reduction, staged [rows][TC + kPad] by `cp.async` into a ring of NST
// chunks in dynamic shared memory, [NST][TP + TJ][TC + kPad].
template <int RP, int RN, int NT>
__global__ void __launch_bounds__(NT, 2)
u_product_kernel(const float* __restrict__ ct, const float* __restrict__ w,
                 float* __restrict__ u, long long M, int N, int R, int vec) {
  constexpr int TP = NT / 16 * RP, TJ = 16 * RN, TC = u_chunk<TP>(), SR = TC + kPad;
  constexpr int NST = u_stages<TP>();
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long p0 = (long long)blockIdx.x * TP;
  const int j0 = blockIdx.y * TJ;
  const int nr = (R + TC - 1) / TC;

  auto issue = [&](int t) {
    if (t < nr) {
      const int r0 = t * TC;
      float* buf = smem + (t % NST) * (TP + TJ) * SR;  // ct rows, then W2 rows
      if (vec) {
        for (int e = tid; e < (TP + TJ) * (TC / 4); e += NT) {
          const int row = e / (TC / 4), r = 4 * (e % (TC / 4));
          if (row < TP) {
            const long long p = p0 + row;
            copy16(buf + row * SR + r, ct + p * R + r0 + r, p < M && r0 + r < R);
          } else {
            const int jg = j0 + row - TP;
            copy16(buf + row * SR + r, w + (long long)jg * R + r0 + r, jg < N && r0 + r < R);
          }
        }
      } else {
        for (int e = tid; e < (TP + TJ) * TC; e += NT) {
          const int row = e / TC, r = e % TC;
          if (row < TP) {
            const long long p = p0 + row;
            copy4(buf + row * SR + r, ct + p * R + r0 + r, p < M && r0 + r < R);
          } else {
            const int jg = j0 + row - TP;
            copy4(buf + row * SR + r, w + (long long)jg * R + r0 + r, jg < N && r0 + r < R);
          }
        }
      }
    }
    copy_commit();
  };

  float acc[RP][RN];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < NST - 1; ++t) issue(t);
  for (int t = 0; t < nr; ++t) {
    copy_wait<NST - 2>();
    __syncthreads();  // chunk t visible; chunk t - 1 no longer read
    issue(t + NST - 1);
    const float* sa = smem + (t % NST) * (TP + TJ) * SR + (RP * ty) * SR;
    const float* sb = smem + (t % NST) * (TP + TJ) * SR + (TP + tx) * SR;
#pragma unroll
    for (int r4 = 0; r4 < TC; r4 += 4) {
      float a[RP][4], bv[RN][4];
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        const float4 q = *reinterpret_cast<const float4*>(sa + i * SR + r4);
        a[i][0] = q.x; a[i][1] = q.y; a[i][2] = q.z; a[i][3] = q.w;
      }
#pragma unroll
      for (int jj = 0; jj < RN; ++jj) {
        const float4 q = *reinterpret_cast<const float4*>(sb + 16 * jj * SR + r4);
        bv[jj][0] = q.x; bv[jj][1] = q.y; bv[jj][2] = q.z; bv[jj][3] = q.w;
      }
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int i = 0; i < RP; ++i)
#pragma unroll
          for (int jj = 0; jj < RN; ++jj) acc[i][jj] = fmaf(a[i][rr], bv[jj][rr], acc[i][jj]);
    }
  }
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const long long p = p0 + RP * ty + i;
    if (p >= M) continue;
#pragma unroll
    for (int jj = 0; jj < RN; ++jj) {
      const int j = j0 + tx + 16 * jj;
      if (j < N) u[p * N + j] = acc[i][jj];
    }
  }
}

// ---------------------------------------------------------------------------
// backward 2: d f by strips and the offset / gate gradients
// ---------------------------------------------------------------------------

__device__ __forceinline__ int floor_div(int a, int s) {
  return a >= 0 ? a / s : -((-a + s - 1) / s);
}

__device__ __forceinline__ int ceil_div(int a, int s) { return -floor_div(-a, s); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// What both kinds of warp read.
struct BwdGeom {
  int B, H, W, C, Ho, Wo, K, kw, m, S;
};

// d f of one item: a strip of kStrip vertically neighbouring input pixels
// (rows iy0 ..) at column ix, and the pass's 32 x VEC channels; one warp,
// lanes over the channels. For each tap, the output pixels whose window can
// reach a pixel of the strip, (2m+1+kStrip)/S rows by (2m+2)/S columns, are
// its candidates: lane j tests candidate j (32 at a time) with the hat sum's
// own expressions for every pixel of the strip, and a ballot gives the hits
// in (y, x) order. The warp loads each hit's U row once and adds
// g * hat * hat * U to the channels of each pixel it reaches, four hits at a
// time. Neighbouring warps take neighbouring columns of one strip row and
// pass, which share the U rows of their hits through L1.
template <int VEC>
__device__ __forceinline__ void df_strip(const float* __restrict__ oy,
                                         const float* __restrict__ ox,
                                         const float* __restrict__ gate,
                                         const float* __restrict__ u, float* __restrict__ df,
                                         const BwdGeom& g, long long item, int lane) {
  const int strips = (g.H + kStrip - 1) / kStrip;
  const int passes = (g.C + 32 * VEC - 1) / (32 * VEC);
  if (item >= (long long)g.B * strips * passes * g.W) return;  // uniform across the warp
  const int ix = (int)(item % g.W);
  long long r = item / g.W;
  const int pass = (int)(r % passes);
  r /= passes;
  const int iy0 = (int)(r % strips) * kStrip;
  const long long b = r / strips;
  const int S = g.S;
  const long long plane = (long long)g.Ho * g.Wo;
  const int c = pass * 32 * VEC + lane * VEC;
  const bool live = c < g.C;
  const float lo = (float)(-g.m), hi = (float)(g.m + 1);
  const int ncx = (2 * g.m + 2) / S;
  float acc[kStrip][VEC];
#pragma unroll
  for (int p = 0; p < kStrip; ++p)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[p][i] = 0.f;

  for (int k = 0; k < g.K; ++k) {
    const int sy = k / g.kw - 1, sx = k % g.kw - 1;
    const long long kplane = (b * g.K + k) * plane;
    const float* oyk = oy + kplane;
    const float* oxk = ox + kplane;
    const float* gk = gate + kplane;
    const float* uk = u + (b * plane * g.K + k) * g.C + c;  // + o * K * C for pixel o
    // candidate rows y: S*y + sy + d on a strip row for d in [-m, m+1]
    const int yf = ceil_div(iy0 - sy - g.m - 1, S);
    const int ncy = floor_div(iy0 + kStrip - 1 - sy + g.m, S) - yf + 1;
    const int xf = ceil_div(ix - sx - g.m - 1, S);
    const int nc = ncy * ncx;
    for (int jb = 0; jb < nc; jb += 32) {
      const int j = jb + lane;
      const int jr = j / ncx, jq = j - jr * ncx;
      const int y = yf + jr, x = xf + jq;
      float cf[kStrip];
#pragma unroll
      for (int p = 0; p < kStrip; ++p) cf[p] = 0.f;
      int o = 0;
      if (j < nc && y >= 0 && y < g.Ho && x >= 0 && x < g.Wo) {
        o = y * g.Wo + x;
        const float dx = (float)(ix - S * x - sx);
        const float wx = fmaxf(0.f, 1.f - fabsf(__ldg(oxk + o) - dx));
        const float o_y = __ldg(oyk + o);
        const float gg = __ldg(gk + o);
#pragma unroll
        for (int p = 0; p < kStrip; ++p) {
          const float dy = (float)(iy0 + p - S * y - sy);
          const float wy = fmaxf(0.f, 1.f - fabsf(o_y - dy));
          if (dy >= lo && dy <= hi && iy0 + p < g.H && wy != 0.f && wx != 0.f)
            cf[p] = gg * wy * wx;
        }
      }
      bool any = false;
#pragma unroll
      for (int p = 0; p < kStrip; ++p) any = any || cf[p] != 0.f;
      unsigned hits = __ballot_sync(kFull, any);
      while (hits) {
        int src[4];
        bool on[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          on[q] = hits != 0u;
          src[q] = on[q] ? __ffs(hits) - 1 : 0;
          hits &= hits - 1u;
        }
        float wq[4][kStrip], v[4][VEC];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int p = 0; p < kStrip; ++p) wq[q][p] = __shfl_sync(kFull, cf[p], src[q]);
          const int oq = __shfl_sync(kFull, o, src[q]);
          if (on[q] && live) load4<VEC>(uk + (long long)oq * g.K * g.C, v[q]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int p = 0; p < kStrip; ++p)
            if (on[q] && live && wq[q][p] != 0.f)
#pragma unroll
              for (int i = 0; i < VEC; ++i) acc[p][i] = fmaf(wq[q][p], v[q][i], acc[p][i]);
      }
    }
  }
  float* dst = df + ((b * g.H + iy0) * g.W + ix) * g.C + c;
#pragma unroll
  for (int p = 0; p < kStrip; ++p) {
    if (!live || iy0 + p >= g.H) continue;
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[(long long)p * g.W * g.C + i] = acc[p][i];
  }
}

// One warp per (output pixel, tap) item.
template <int VEC>
__device__ __forceinline__ void offset_grads(const float* __restrict__ f,
                                             const float* __restrict__ oy,
                                             const float* __restrict__ ox,
                                             const float* __restrict__ gate,
                                             const float* __restrict__ u,
                                             float* __restrict__ doy, float* __restrict__ dox,
                                             float* __restrict__ dgate, const BwdGeom& gm,
                                             long long item, int lane) {
  const int H = gm.H, W = gm.W, C = gm.C, Ho = gm.Ho, Wo = gm.Wo, K = gm.K, kw = gm.kw;
  const int m = gm.m, S = gm.S;
  if (item >= (long long)gm.B * Ho * Wo * K) return;  // uniform across the warp
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

// Blocks [0, df_blocks) take d f strips (a warp each); the rest compute
// d oy, d ox and d gate.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
fused_bwd_sample_kernel(const float* __restrict__ f, const float* __restrict__ oy,
                        const float* __restrict__ ox, const float* __restrict__ gate,
                        const float* __restrict__ u, float* __restrict__ df,
                        float* __restrict__ doy, float* __restrict__ dox,
                        float* __restrict__ dgate, BwdGeom g, long long df_blocks) {
  const int lane = threadIdx.x % 32;
  if ((long long)blockIdx.x < df_blocks) {
    df_strip<VEC>(oy, ox, gate, u, df, g, (long long)blockIdx.x * kWarps + threadIdx.x / 32,
                  lane);
  } else {
    offset_grads<VEC>(f, oy, ox, gate, u, doy, dox, dgate, g,
                      ((long long)blockIdx.x - df_blocks) * kWarps + threadIdx.x / 32, lane);
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The threads of each tile, measured on the card (PERF.md): the forward's
// 32- and 16-row tiles run 128 threads of 4 x 8 and 2 x 4 outputs (256 of
// 2 x 8 took 1.2x as long, 256 of 1 x 4 1.25x, 64 of 4 x 4 1.4x); its
// 64-row tile and U's tiles run 256 threads of 4 x 8, 2 x 8 or 1 x 4 (128
// of 8 x 8 took 1.04x as long in the forward and 1.03x-1.1x in U).
template <int RP, int RN, int NT, int VEC>
cudaError_t launch_fwd(const float* f, const float* oy, const float* ox, const float* gate,
                       const float* w, float* out, int H, int W, int C, int Ho, int Wo, int K,
                       int kw, int Cout, int m, int S, long long npix, int wvec, int ovec,
                       cudaStream_t s) {
  constexpr int TP = NT / 16 * RP, TN = 16 * RN;
  const long long gx = (npix + TP - 1) / TP;
  const int gy = (Cout + TN - 1) / TN;
  const long long bytes = 4 * fwd_smem_floats(TP, TN, kFwdStages, fwd_chunk<TP>(), C, K);
  if (gx > 2147483647LL || gy > 65535 || bytes > kMaxSmem) return cudaErrorInvalidConfiguration;
  auto kernel = fused_fwd_kernel<RP, RN, NT, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)gx, gy), NT, (size_t)bytes, s>>>(
      f, oy, ox, gate, w, out, H, W, C, Ho, Wo, K, kw, Cout, m, S, npix, wvec, ovec);
  return cudaGetLastError();
}

template <int RP, int RN, int NT>
cudaError_t launch_u(const float* ct, const float* w, float* u, long long M, int N, int R,
                     int vec, cudaStream_t s) {
  constexpr int TP = NT / 16 * RP, TJ = 16 * RN;
  const long long gx = (M + TP - 1) / TP;
  const int gy = (N + TJ - 1) / TJ;
  if (gx > 2147483647LL || gy > 65535) return cudaErrorInvalidConfiguration;
  const int bytes = 4 * u_stages<TP>() * (TP + TJ) * (u_chunk<TP>() + kPad);
  auto kernel = u_product_kernel<RP, RN, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)gx, gy), NT, (size_t)bytes, s>>>(ct, w, u, M, N, R, vec);
  return cudaGetLastError();
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ff = static_cast<const float*>(f);
  const float* fy = static_cast<const float*>(oy);
  const float* fx = static_cast<const float*>(ox);
  const float* fg = static_cast<const float*>(gate);
  const float* fw = static_cast<const float*>(w);
  float* fo = static_cast<float*>(out);
  const long long npix = (long long)B * Ho * Wo;
  // 16-byte loads of the features and of W, and stores of the output, where
  // the channel counts and the pointers allow them
  const bool fvec = C % 4 == 0 && aligned16(f);
  const int wvec = Cout % 4 == 0 && aligned16(w);
  const int ovec = Cout % 4 == 0 && aligned16(out);
  const Tile t = pick_tile(npix, Cout);
  cudaError_t err;
#define LPI_FWD(RP, RN, NT, VEC)                                                                  \
  launch_fwd<RP, RN, NT, VEC>(ff, fy, fx, fg, fw, fo, H, W, C, Ho, Wo, K, kw, Cout, m, stride,    \
                              npix, wvec, ovec, s)
  if (t.tp == 64)
    err = fvec ? LPI_FWD(4, 8, 256, 4) : LPI_FWD(4, 8, 256, 1);
  else if (t.tp == 32)
    err = fvec ? LPI_FWD(4, 8, 128, 4) : LPI_FWD(4, 8, 128, 1);
  else
    err = fvec ? LPI_FWD(2, 4, 128, 4) : LPI_FWD(2, 4, 128, 1);
#undef LPI_FWD
  return (int)err;
}

// Pixel ranges of the d W pass for its [splits, K, C, Cout] scratch: about
// eight waves of its 64 x 64 tiles over 132 SMs, each range at least 256
// output pixels. Fixed by the shape alone (not read from the card), so that
// d W's bits do not depend on the card.
extern "C" int lpi_fused_deform_dw_splits(long long npix, int K, int C, int Cout) {
  const long long tiles = (long long)K * ((C + kTP - 1) / kTP) * ((Cout + kTN - 1) / kTN);
  const long long by_pixels = (npix + 255) / 256;
  const long long by_waves = (8LL * kSMs + tiles - 1) / tiles;
  const long long splits = by_pixels < by_waves ? by_pixels : by_waves;
  return (int)(splits < 1 ? 1 : (splits > 65535 ? 65535 : splits));
}

// Backward of `lpi_fused_deform_fwd` for the cotangent ct [B, Ho, Wo, Cout]:
// df [B, H, W, C], doy/dox/dgate [B, K, Ho, Wo], and, when dw is not null,
// dw [K, C, Cout]. Scratch from the caller: u [B*Ho*Wo, K*C] and, with dw,
// partial [splits, K, C, Cout]. Every output element is written. `vec` (4 or
// 1) is the channel group of d f and of the offset warps; 4 needs C % 4 == 0
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

  const int uvec = Cout % 4 == 0 && aligned16(ct) && aligned16(w);
  const Tile t = pick_tile(npix, (long long)K * C);
  cudaError_t err;
  if (t.tp == 64)
    err = launch_u<4, 8, 256>(fc, fw, fu, npix, K * C, Cout, uvec, s);
  else if (t.tp == 32)
    err = launch_u<2, 8, 256>(fc, fw, fu, npix, K * C, Cout, uvec, s);
  else
    err = launch_u<1, 4, 256>(fc, fw, fu, npix, K * C, Cout, uvec, s);
  if (err != cudaSuccess) return (int)err;

  const BwdGeom g{B, H, W, C, Ho, Wo, K, kw, m, stride};
  const long long df_items = (long long)B * ((H + kStrip - 1) / kStrip) *
                             ((C + 32 * vec - 1) / (32 * vec)) * W;
  const long long df_blocks = (df_items + kWarps - 1) / kWarps;
  const long long off_blocks = (npix * K + kWarps - 1) / kWarps;
  if (df_blocks + off_blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const unsigned nb = (unsigned)(df_blocks + off_blocks);
  if (vec == 4)
    fused_bwd_sample_kernel<4><<<nb, kThreads, 0, s>>>(
        ff, fy, fx, fg, fu, static_cast<float*>(df), static_cast<float*>(doy),
        static_cast<float*>(dox), static_cast<float*>(dgate), g, df_blocks);
  else
    fused_bwd_sample_kernel<1><<<nb, kThreads, 0, s>>>(
        ff, fy, fx, fg, fu, static_cast<float*>(df), static_cast<float*>(doy),
        static_cast<float*>(dox), static_cast<float*>(dgate), g, df_blocks);
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
