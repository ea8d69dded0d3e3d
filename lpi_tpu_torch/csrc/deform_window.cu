// Gated 9-tap deform-window sums for the VLDyHead's deformable 3x3 convs,
// stride 1 and stride 2, written for Hopper (sm_90a).
//
// Replaces the forward Pallas TPU kernels of
// `lpi_tpu/ops/deform_window_kernel.py`:
//   * `window_accumulate_taps_inpad` (`_fwd_taps_inpad_kernel`), stride 1;
//   * `window_accumulate_taps_s2` (`_fwd_taps_s2_kernel`), stride 2. The
//     TPU kernel reads four parity phases of a pre-shifted, padded map; here
//     the kernel reads the UNPADDED map at input resolution with strided
//     addresses, so no phase split and no padding pass exist.
//
// What it computes (h_all = feats @ W, tap-major channels [B, H, W, K*Cout]):
//
//   out[b,y,x,c] = sum_k g_k * sum_{dy,dx in [-m, m+1]} hat(oy_k, dy)
//                  * hat(ox_k, dx) * h_k[S*y + ky - 1 + dy, S*x + kx - 1 + dx, c]
//
// with hat(o, d) = max(0, 1 - |o - d|), (ky, kx) = (k / kw, k % kw), stride S,
// zero outside the map, and oy/ox/g = [B, K, Ho, Wo] float32. The offsets are
// clamped to [-m, m] by the caller, so for each tap at most two displacements
// per axis carry weight: floor(o) and floor(o) + 1. The 64-term hat sum is
// therefore a 4-corner bilinear sample with zero padding. The kernel visits
// exactly those corners, computes each weight with the same float expression
// as the hat sum (so integer offsets and o = +m give the same 1 / 0 weights),
// skips displacements outside [-m, m+1] as the hat sum's window does, and adds
// the nonzero terms in the hat sum's order (k, then dy, then dx ascending).
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores):
// bytes. The floor reads the rows of h_all that carry weight once, the
// offsets and gate once, and writes out once. At P3 of the 448 px train step
// (4 x 56 x 56, K*Cout = 2304, bf16) with offsets spread over [-m, m] nearly
// every row carries weight: about 53 MB + 1.4 MB + 12.8 MB, 20 us; at stride
// 2 an output reads at most 4 rows per tap, about half of h, 9 us. The
// arithmetic (4 corners x 9 taps x 2 flops per output value) is under 2 us.
// What the card pays above the floor, and what the design does:
//
// * Dependent loads. Each corner's address depends on its tap's offsets: a
//   thread that walks the taps loading offsets, then corners, waits on about
//   18 loads one after another, and at the small maps (4x4 to 14x14 at
//   batch 4: 64 to 784 pixels) too few warps hide it (8-12 us a launch
//   against a floor under 1.5 us). Here a block first builds its tile's
//   corner table in shared memory: one thread per (pixel, tap) loads that
//   tap's offsets and gate (coalesced along x, all taps in one round trip)
//   and writes the four corners' weights and rows. The sum then reads the
//   table and issues a tap's four corner loads at once.
// * Too few blocks. A block takes a tile of P output pixels, P a power of
//   two chosen at launch from the shape: the largest (at most 256 threads a
//   block) that still gives every SM two blocks, down to one warp's worth.
//   So the small maps get one or two pixels a block and fill the card.
// * Occupancy. The large maps are bound by the corners' re-reads through
//   L2 (each row of h is read by up to four outputs: reckoned, about 185 MB
//   at P3 bf16 where the floor reads 53 MB), which needs many warps with
//   loads in flight. More taps in flight a thread (three: 175 registers for
//   bf16, one block an SM) ran slower than one tap at 64 registers a
//   thread, four blocks an SM (kFwdMinBlocks); fewer registers spill.
// * Re-reads. The tile is two-dimensional (2 x 4 pixels for a bf16 Cout of
//   256) so that a block's corners overlap more than those of a row of
//   pixels; the rest come from L2 (the rows in flight fit in its 50 MB).
//
// Thread mapping of the sum: one thread owns VEC neighbouring output channels
// of one output pixel (VEC = 8 for bf16, 4 for fp32: one 16-byte load per
// corner); neighbouring threads take neighbouring channel groups of the same
// pixel, so a warp's corner reads are contiguous in the NHWC, tap-major
// h_all, and its table reads are broadcasts. Accumulation is fp32 in
// registers, with fused multiply-adds in the hat sum's order (k, then dy,
// then dx), so the output carries the bits of a thread that walks the taps
// one after another; it is written once, fp32. No atomics: two calls give
// equal bits.
//
// ---------------------------------------------------------------------------
// Backward (`lpi_window_taps_bwd`): replaces the Pallas TPU kernels
// `_bwd_taps_inpad_kernel` (stride 1, the VJP of
// `window_accumulate_taps_inpad`) and `_bwd_taps_s2_kernel` (stride 2, the
// VJP of `window_accumulate_taps_s2`; there it returns d of the four parity
// phases, here d of the unpadded map). Given the cotangent ct [B, Ho, Wo,
// Cout] fp32 it returns
//
//   dh_k[r, c]  = sum over (y, x, dy, dx) with r = (S*y + ky - 1 + dy, ...)
//                 of g * hat(oy, dy) * hat(ox, dx) * ct[y, x, c]
//   doy = sum_corners g * dhat(oy, dy) * hat(ox, dx) * s
//   dox = sum_corners g * hat(oy, dy) * dhat(ox, dx) * s
//   dg  = sum_corners hat(oy, dy) * hat(ox, dx) * s,   s = sum_c ct[c] * h_k[corner, c]
//
// with dhat(o, d) = -sign(o - d) where |o - d| < 1, else 0 (so an integer
// offset gives 0 from every displacement). One launch runs two kinds of
// block, the d h blocks first:
//
// * d h, one warp per item: a strip of kStrip = 4 vertically neighbouring
//   input pixels and one tap, lanes over the channels (8 bf16 or 4 fp32 each:
//   16-byte loads and stores; 256 channels in one pass for bf16, two for
//   fp32). The output pixels whose window can reach the strip, about
//   (2m+1+kStrip)/S rows by (2m+2)/S columns (88 at stride 1 and 20 to 24 at
//   stride 2 for m = 3), are its candidates: lane j tests candidate j, 32 at
//   a time, with the hat sum's own float expressions, for every pixel of the
//   strip, and a ballot gives the hits in (y, x) order. Per hit the warp
//   loads the output's cotangent row once and adds g * hat * hat * ct to the
//   channels of each pixel it reaches, four hits at a time, with fused
//   multiply-adds in that order: per pixel, the same terms in the same order
//   as a serial gather over the output positions (row, then column), so an
//   fp32 d h carries that gather's bits. d h is written once, in h_all's dtype,
//   after the fp32 sum: no atomics, no zero fill, and two calls give equal
//   bits. The strip shares an output's cotangent row between the rows of
//   its corners, and neighbouring warps (the strips of one row of strips
//   and one tap) share it between their columns through L1.
// * d oy, d ox, d gate, one warp per item of one output pixel and
//   off_taps taps (3 for fp32 maps, 1 for bf16): lanes stride over the Cout
//   channels VEC at a time, form the four corner dot products s of each tap
//   with all the item's corner loads in flight, and one warp-shuffle sum per
//   result ends them (the sums of a warp per (pixel, tap), in its order, so
//   the results carry its bits). The corners are skipped only outside the
//   per-axis support |o - d| < 1 (which hat and dhat share), the window and
//   the map, never on the gate: dgate does not carry g. Both kinds share one
//   register budget (at most 128 a thread, two blocks an SM, set by the d h
//   strips); three fp32 taps per warp keep more corner loads in flight at
//   two blocks an SM, while three bf16 taps (8 channels a lane) spill.
//   Neither kind uses shared memory (0 bytes a block):
//   the rows each warp re-reads, its hits' cotangent rows and its corners'
//   h rows, come through L1 and the 50 MB L2.
//
// Bound on an H100: bytes. The floor reads h_all, ct and the three offset
// maps once and writes dh_all and the three gradient maps once: at P3 of the
// 448 px train step (4 x 56 x 56, K*Cout = 2304, bf16) that is 2 x 58 MB +
// 12.8 MB + 2 x 1.4 MB, about 39 us. The arithmetic (4 corners x 2 flops per
// channel for s and for d h) is a few us at the fp32 rate. What the design
// pays above the floor: each hit reads a 1 KB fp32 cotangent row (about 36
// hits per input pixel over the nine taps) from L1 or L2 instead of once,
// and the offset half reads each h corner (4 per output and tap) from L2.
// A gather whose threads each tested the 64 candidates of one (pixel, tap)
// one after another, with dependent loads, spent 80% of its launch in the d
// h half; tiles of the cotangent staged in shared memory, 32 or 64 channels
// per block, were measured slower than this design (each item's tests were
// repeated per channel chunk). PERF.md has the measurements.
//
// ---------------------------------------------------------------------------
// The pre-padded sums (`lpi_window_padded_fwd`, `lpi_window_padded_bwd`, the
// PADDED template flag): replace the Pallas TPU kernels of
//   * `window_accumulate_taps` (`_fwd_taps_kernel`, VJP `_bwd_taps_kernel`):
//     the gated K-tap sum over a pre-shifted, pre-padded map hp_all [B,
//     Ho+2m+1, Wo+2m+1, K*Cout], fp32 or bf16, in which each tap's (ky, kx)
//     shift is baked into its pad, so tap k reads hp_k[y + m + dy, x + m + dx]
//     (always inside the map for dy, dx in [-m, m+1]);
//   * `window_accumulate` (`_fwd_kernel`, VJP `_bwd_kernel`): the single map
//     hp [B, Ho+2m+1, Wo+2m+1, C] fp32, no gate (K = 1, a null gate is g = 1,
//     and the backward writes no dgate).
// Same kernels, same corner rule, same d h strips and offset warps as above,
// at stride 1; only the row and column shift of each tap differs. d hp covers
// every position of the padded map, the pad ring included, as the JAX VJP
// returns it. A bf16 d hp is summed in fp32 and rounded once (the TPU kernel
// rounds after every displacement).
//
// Bound on an H100 (3.35 TB/s), bytes, at P3 of 448 px, batch 4, Cout 256:
// row 3 with a bf16 hp_all [4, 63, 63, 2304]: forward 87.36 MB (hp 73.2 MB,
// offsets and gate 1.4 MB, out 12.8 MB), 26.1 us; backward 161.9 MB (hp read
// and d hp written, ct, offsets read and their gradients written), 48.3 us;
// fp32 hp: 47.9 us and 92.0 us. Row 4 at hp [4, 63, 63, 256] fp32: forward
// 29.2 MB, 8.7 us; backward 45.6 MB, 13.6 us. The arithmetic is a few us at
// the fp32 rate. The padded map is 13% larger than the unpadded one and its
// pad ring is read only by border pixels, so the same design applies.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Load VEC consecutive elements as floats; VEC * sizeof(T) == 16 uses one
// 16-byte load (the wrapper checks alignment before choosing VEC > 1).
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_float(p[i]);
  }
}

// Row shift of tap index t (ky or kx) in the map the kernel reads: the
// unpadded map reads h_k[S*y + t - 1 + d]; the pre-shifted, pre-padded map
// has every tap's shift baked into its pad and reads hp_k[y + m + d].
template <bool PADDED>
__device__ __forceinline__ int tap_shift(int t, int m) { return PADDED ? m : t - 1; }

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = 256;         // at most, a block
constexpr int kFwdMinBlocks = 4;         // blocks an SM, so at most 64 registers a thread
constexpr int kTableBytes = 48 * 1024;   // a block's corner table at most

// The four corners (dy, dx) = (floor, floor), (floor, floor + 1), (floor + 1,
// floor), (floor + 1, floor + 1) of one (output pixel, tap): their weights
// g * hat * hat, 0 for a corner that is skipped, and their rows iy * W + ix.
struct Corners {
  float4 w;
  int4 r;
};

struct FwdGeom {
  int H, W, Ho, Wo, K, kw, Cout, m;
  int tile_y, tile_x;    // a block's tile of output pixels: tile_y * tile_x = blockDim.y
  int tiles_y, tiles_x;  // tiles per image
};

// VEC consecutive elements of T, loaded with one 16-byte load where VEC *
// sizeof(T) == 16 (the wrapper checks alignment before choosing VEC > 1),
// kept as loaded until they are added: converted at the load (`load_vec`),
// the bf16 forward took 30% longer at P3.
template <typename T, int VEC>
struct alignas(VEC * sizeof(T) == 16 ? 16 : alignof(T)) Packed {
  T e[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Packed<T, VEC> load_packed(const T* __restrict__ p) {
  Packed<T, VEC> v;
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(&v) = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v.e[i] = p[i];
  }
  return v;
}

// The corners of output pixel (yo, xo) and tap k of image b, each weighted
// with the hat sum's own float expressions; a corner outside the window
// [-m, m+1] or the map keeps weight 0.
template <int STRIDE, bool PADDED>
__device__ __forceinline__ Corners corners_of(const float* __restrict__ oy,
                                              const float* __restrict__ ox,
                                              const float* __restrict__ gate,
                                              const FwdGeom& g, long long b, int k, int yo,
                                              int xo) {
  const long long o = ((b * g.K + k) * g.Ho + yo) * g.Wo + xo;
  const float o_y = __ldg(oy + o), o_x = __ldg(ox + o);
  const float gg = gate ? __ldg(gate + o) : 1.f;
  const float fy = floorf(o_y), fx = floorf(o_x);
  const float lo = (float)(-g.m), hi = (float)(g.m + 1);
  const int by = STRIDE * yo + tap_shift<PADDED>(k / g.kw, g.m);
  const int bx = STRIDE * xo + tap_shift<PADDED>(k % g.kw, g.m);
  float w[4] = {0.f, 0.f, 0.f, 0.f};
  int r[4] = {0, 0, 0, 0};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float dy = fy + (float)a;
    const int iy = by + (int)dy;
    if (dy < lo || dy > hi || iy < 0 || iy >= g.H) continue;
    const float gwy = gg * fmaxf(0.f, 1.f - fabsf(o_y - dy));
#pragma unroll
    for (int bb = 0; bb < 2; ++bb) {
      const float dx = fx + (float)bb;
      const int ix = bx + (int)dx;
      if (dx < lo || dx > hi || ix < 0 || ix >= g.W) continue;
      w[2 * a + bb] = gwy * fmaxf(0.f, 1.f - fabsf(o_x - dx));
      r[2 * a + bb] = iy * g.W + ix;
    }
  }
  return {make_float4(w[0], w[1], w[2], w[3]), make_int4(r[0], r[1], r[2], r[3])};
}

// One block per tile of blockDim.y output pixels (tile_y x tile_x of one
// image) and blockDim.x * VEC channels. First the tile's corner table,
// [K][pixels] in shared memory, one (pixel, tap) per thread; then each thread
// sums its pixel's VEC channels, one tap's four corner loads at a time.
template <typename T, int STRIDE, bool PADDED, int VEC>
__global__ void __launch_bounds__(kFwdThreads, kFwdMinBlocks)
window_taps_kernel(const T* __restrict__ h, const float* __restrict__ oy,
                   const float* __restrict__ ox, const float* __restrict__ gate,
                   float* __restrict__ out, const FwdGeom g) {
  extern __shared__ Corners table[];
  const int P = blockDim.y;
  long long t = blockIdx.x;
  const int x0 = (int)(t % g.tiles_x) * g.tile_x;
  t /= g.tiles_x;
  const int y0 = (int)(t % g.tiles_y) * g.tile_y;
  const long long b = t / g.tiles_y;

  // pixels fastest, so that a warp's offset and gate loads run along x
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < g.K * P; i += blockDim.x * P) {
    const int p = i % P;
    const int yo = y0 + p / g.tile_x, xo = x0 + p % g.tile_x;
    table[i] = yo < g.Ho && xo < g.Wo
                   ? corners_of<STRIDE, PADDED>(oy, ox, gate, g, b, i / P, yo, xo)
                   : Corners{make_float4(0.f, 0.f, 0.f, 0.f), make_int4(0, 0, 0, 0)};
  }
  __syncthreads();

  const int p = threadIdx.y;
  const int yo = y0 + p / g.tile_x, xo = x0 + p % g.tile_x;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (yo >= g.Ho || xo >= g.Wo || c0 >= g.Cout) return;
  const long long KC = (long long)g.K * g.Cout;
  const T* hb = h + b * g.H * g.W * KC + c0;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int k = 0; k < g.K; ++k) {
    const Corners c = table[k * P + p];
    const float w[4] = {c.w.x, c.w.y, c.w.z, c.w.w};
    const int r[4] = {c.r.x, c.r.y, c.r.z, c.r.w};
    const T* hk = hb + (long long)k * g.Cout;
    Packed<T, VEC> v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (w[j] != 0.f) v[j] = load_packed<T, VEC>(hk + r[j] * KC);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (w[j] != 0.f)
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(w[j], to_float(v[j].e[i]), acc[i]);
  }

  float* o = out + ((b * g.Ho + yo) * g.Wo + xo) * g.Cout + c0;
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(o + i) = make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = acc[i];
  }
}

// A tile of P output pixels (a power of two), as square as P allows and no
// wider than the map needs.
void set_tile(FwdGeom& g, int P) {
  int lg = 0;
  while ((1 << lg) < P) ++lg;
  int tx = 1 << ((lg + 1) / 2);
  while (tx > 1 && tx / 2 >= g.Wo) tx /= 2;
  g.tile_x = tx;
  g.tile_y = P / tx;
  g.tiles_x = (g.Wo + g.tile_x - 1) / g.tile_x;
  g.tiles_y = (g.Ho + g.tile_y - 1) / g.tile_y;
}

// The block's pixels P: the largest power of two with at most kFwdThreads
// threads and a corner table of at most kTableBytes that still gives every
// SM two blocks, and no fewer than a warp's worth where the table allows.
template <typename T, int STRIDE, bool PADDED, int VEC>
cudaError_t launch(const void* h, const float* oy, const float* ox, const float* gate,
                   float* out, int B, int H, int W, int Ho, int Wo, int K, int kw,
                   int Cout, int m, cudaStream_t stream) {
  const int groups = Cout / VEC;
  const int bx = groups < kFwdThreads ? groups : kFwdThreads;
  const int gy = (groups + bx - 1) / bx;
  int most = kFwdThreads / bx;
  const int table_most = kTableBytes / (K * (int)sizeof(Corners));
  if (table_most < 1) return cudaErrorInvalidValue;
  if (most > table_most) most = table_most;
  int pmax = 1, pmin = 1;
  while (pmax * 2 <= most) pmax *= 2;
  while (pmin * bx < 32 && pmin < pmax) pmin *= 2;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  FwdGeom g{H, W, Ho, Wo, K, kw, Cout, m, 0, 0, 0, 0};
  long long blocks = 0;
  for (int P = pmax;; P /= 2) {
    set_tile(g, P);
    blocks = (long long)B * g.tiles_y * g.tiles_x;
    if (P == pmin || blocks * gy >= 2LL * sms) break;
  }
  if (blocks > 2147483647LL || gy > 65535) return cudaErrorInvalidConfiguration;
  dim3 block(bx, g.tile_y * g.tile_x);
  dim3 grid((unsigned)blocks, (unsigned)gy);
  const size_t table = (size_t)K * block.y * sizeof(Corners);
  window_taps_kernel<T, STRIDE, PADDED, VEC><<<grid, block, table, stream>>>(
      static_cast<const T*>(h), oy, ox, gate, out, g);
  return cudaGetLastError();
}

template <int STRIDE, bool PADDED>
cudaError_t dispatch(const void* h, const float* oy, const float* ox, const float* gate,
                     float* out, int B, int H, int W, int Ho, int Wo, int K, int kw,
                     int Cout, int m, int is_bf16, int vec, cudaStream_t s) {
  if (is_bf16) {
    if (vec == 8) return launch<__nv_bfloat16, STRIDE, PADDED, 8>(h, oy, ox, gate, out, B, H, W, Ho, Wo, K, kw, Cout, m, s);
    if (vec == 1) return launch<__nv_bfloat16, STRIDE, PADDED, 1>(h, oy, ox, gate, out, B, H, W, Ho, Wo, K, kw, Cout, m, s);
  } else {
    if (vec == 4) return launch<float, STRIDE, PADDED, 4>(h, oy, ox, gate, out, B, H, W, Ho, Wo, K, kw, Cout, m, s);
    if (vec == 1) return launch<float, STRIDE, PADDED, 1>(h, oy, ox, gate, out, B, H, W, Ho, Wo, K, kw, Cout, m, s);
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kStrip = 4;    // input pixels of one d h item, one above the other
constexpr unsigned kFull = 0xffffffffu;

// Taps of one offset item: as many corner loads in flight as 128 registers
// hold. Three taps at 4 fp32 channels a lane (or 1); at 8 bf16 channels a
// lane, three taps spill 320 bytes a thread and run 1.6x slower than one.
template <int VEC>
constexpr int off_taps = VEC >= 8 ? 1 : 3;

// What both kinds of warp read, planned once per launch.
struct BwdGeom {
  int B, H, W, Ho, Wo, K, kw, Cout, m;
};

__device__ __forceinline__ void from_float(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

// Store VEC floats as T; VEC * sizeof(T) == 16 uses one 16-byte store.
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) from_float(v[i], e + i);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) from_float(v[i], p + i);
  }
}

// Load VEC fp32 cotangent values (16-byte loads when VEC is a multiple of 4).
template <int VEC>
__device__ __forceinline__ void load_ct(const float* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
  }
}

__device__ __forceinline__ int floor_div(int a, int s) {
  return a >= 0 ? a / s : -((-a + s - 1) / s);
}

__device__ __forceinline__ int ceil_div(int a, int s) { return -floor_div(-a, s); }

// d h of one item: a strip of kStrip vertically neighbouring input pixels
// (rows iy0 ..) and one tap; one warp, lanes over the channels (VEC each,
// 32 x VEC channels per pass). The output pixels whose window can reach a
// pixel of the strip, (2m+1+kStrip)/S rows by (2m+2)/S columns, are its
// candidates: lane j tests candidate j (32 at a time) with the hat sum's own
// expressions, for every pixel of the strip, and a ballot gives the hits in
// (y, x) order. The warp loads each hit's cotangent row once and adds g *
// hat * hat * ct to the channels of each pixel it reaches, four hits at a
// time. Item order puts the strips of one row and tap in neighbouring warps,
// which share the cotangent rows of their corners through L1. H x W is the
// map's own size (the padded size in the PADDED mode, whose d hp covers the
// pad ring too).
template <typename T, int STRIDE, bool PADDED, int VEC>
__device__ __forceinline__ void dh_strip(const float* __restrict__ oy,
                                         const float* __restrict__ ox,
                                         const float* __restrict__ gate,
                                         const float* __restrict__ ct, T* __restrict__ dh,
                                         const BwdGeom& g, long long item, int lane) {
  const int strips = (g.H + kStrip - 1) / kStrip;
  if (item >= (long long)g.B * g.K * strips * g.W) return;  // uniform across the warp
  const int ix = (int)(item % g.W);
  long long r = item / g.W;
  const int iy0 = (int)(r % strips) * kStrip;
  r /= strips;
  const int k = (int)(r % g.K);
  const long long b = r / g.K;
  const int sy = tap_shift<PADDED>(k / g.kw, g.m), sx = tap_shift<PADDED>(k % g.kw, g.m);
  const long long plane = (long long)g.Ho * g.Wo;
  const long long kplane = (b * g.K + k) * plane;
  const float* oyk = oy + kplane;
  const float* oxk = ox + kplane;
  const float* gk = gate ? gate + kplane : nullptr;
  const float* ctb = ct + b * plane * g.Cout;
  const long long KC = (long long)g.K * g.Cout;
  T* dhp = dh + ((b * g.H + iy0) * g.W + ix) * KC + (long long)k * g.Cout;
  const float lo = (float)(-g.m), hi = (float)(g.m + 1);
  // candidate rows y: S*y + sy + d on a strip row for d in [-m, m+1]
  const int yf = ceil_div(iy0 - sy - g.m - 1, STRIDE);
  const int ncy = floor_div(iy0 + kStrip - 1 - sy + g.m, STRIDE) - yf + 1;
  const int xf = ceil_div(ix - sx - g.m - 1, STRIDE), ncx = (2 * g.m + 2) / STRIDE;
  const int nc = ncy * ncx;
  // row and column of the lane's first two candidates, j = lane and lane + 32
  const int r0 = lane / ncx, r1 = (lane + 32) / ncx;
  const int q0 = lane - r0 * ncx, q1 = lane + 32 - r1 * ncx;

  for (int c0 = 0; c0 < g.Cout; c0 += 32 * VEC) {
    const int c = c0 + lane * VEC;
    const bool live = c < g.Cout;
    float acc[kStrip][VEC];
#pragma unroll
    for (int p = 0; p < kStrip; ++p)
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[p][i] = 0.f;
    for (int jb = 0; jb < nc; jb += 32) {
      const int j = jb + lane;
      int jr = r0, jq = q0;
      if (jb == 32) {
        jr = r1;
        jq = q1;
      } else if (jb > 32) {
        jr = j / ncx;
        jq = j - jr * ncx;
      }
      const int y = yf + jr, x = xf + jq;
      float cf[kStrip];
#pragma unroll
      for (int p = 0; p < kStrip; ++p) cf[p] = 0.f;
      int o = 0;
      if (j < nc && y >= 0 && y < g.Ho && x >= 0 && x < g.Wo) {
        o = y * g.Wo + x;
        const float dx = (float)(ix - STRIDE * x - sx);
        const float wx = fmaxf(0.f, 1.f - fabsf(__ldg(oxk + o) - dx));
        const float o_y = __ldg(oyk + o);
        const float gg = gk ? __ldg(gk + o) : 1.f;
#pragma unroll
        for (int p = 0; p < kStrip; ++p) {
          const float dy = (float)(iy0 + p - STRIDE * y - sy);
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
        for (int u = 0; u < 4; ++u) {
          on[u] = hits != 0u;
          src[u] = on[u] ? __ffs(hits) - 1 : 0;
          hits &= hits - 1u;
        }
        float w[4][kStrip], v[4][VEC];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int p = 0; p < kStrip; ++p) w[u][p] = __shfl_sync(kFull, cf[p], src[u]);
          const int ou = __shfl_sync(kFull, o, src[u]);
          if (on[u] && live) load_ct<VEC>(ctb + (long long)ou * g.Cout + c, v[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int p = 0; p < kStrip; ++p)
            if (on[u] && live && w[u][p] != 0.f)
#pragma unroll
              for (int i = 0; i < VEC; ++i) acc[p][i] = fmaf(w[u][p], v[u][i], acc[p][i]);
      }
    }
#pragma unroll
    for (int p = 0; p < kStrip; ++p)
      if (live && iy0 + p < g.H) store_vec<T, VEC>(dhp + p * g.W * KC + c, acc[p]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// d oy, d ox, d gate: one warp per item of one output pixel and kTaps =
// off_taps<VEC> taps (k0 ..). Lanes stride over the Cout channels VEC at a time and form
// the four corner dot products s of every tap of the item, with all its
// corner loads in flight at once; one warp-shuffle sum per result ends
// them (the sums of a warp per (pixel, tap), in its order, so the results
// carry its bits). The corners are skipped only outside the per-axis support
// |o - d| < 1 (which hat and dhat share), the window and the map, never on
// the gate: dgate does not carry g. Without a gate (null `gate`, g = 1)
// dgate is null and not written.
template <typename T, int STRIDE, bool PADDED, int VEC>
__device__ __forceinline__ void offset_grads(
    const T* __restrict__ h, const float* __restrict__ oy, const float* __restrict__ ox,
    const float* __restrict__ gate, const float* __restrict__ ct, float* __restrict__ doy,
    float* __restrict__ dox, float* __restrict__ dgate, const BwdGeom& g, long long item,
    int lane) {
  constexpr int kTaps = off_taps<VEC>;
  const int groups = (g.K + kTaps - 1) / kTaps;
  if (item >= (long long)g.B * g.Ho * g.Wo * groups) return;  // uniform across the warp
  const int k0 = (int)(item % groups) * kTaps;
  const long long pix = item / groups;
  const int xo = (int)(pix % g.Wo);
  const long long rest = pix / g.Wo;
  const int yo = (int)(rest % g.Ho);
  const long long b = rest / g.Ho;
  const long long KC = (long long)g.K * g.Cout;
  const long long plane = (long long)g.Ho * g.Wo;
  const float lo = (float)(-g.m), hi = (float)(g.m + 1);

  long long oidx[kTaps];
  float gg[kTaps], wy[kTaps][2], dwy[kTaps][2], wx[kTaps][2], dwx[kTaps][2];
  long long corner[kTaps][2][2];  // element offset of each corner's row in h
  bool on[kTaps][2][2];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const int k = k0 + t;
    oidx[t] = (b * g.K + k) * plane + (long long)yo * g.Wo + xo;
    const bool tap = k < g.K;
    const float o_y = tap ? __ldg(oy + oidx[t]) : 0.f, o_x = tap ? __ldg(ox + oidx[t]) : 0.f;
    gg[t] = tap && gate ? __ldg(gate + oidx[t]) : 1.f;
    const int by = STRIDE * yo + tap_shift<PADDED>(k / g.kw, g.m);
    const int bx = STRIDE * xo + tap_shift<PADDED>(k % g.kw, g.m);
    int ry[2], rx[2];
    bool vy[2], vx[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const float dy = floorf(o_y) + (float)a;
      const float ty = o_y - dy;
      ry[a] = by + (int)dy;
      vy[a] = tap && dy >= lo && dy <= hi && ry[a] >= 0 && ry[a] < g.H && fabsf(ty) < 1.f;
      wy[t][a] = fmaxf(0.f, 1.f - fabsf(ty));
      dwy[t][a] = ty > 0.f ? -1.f : (ty < 0.f ? 1.f : 0.f);
      const float dx = floorf(o_x) + (float)a;
      const float tx = o_x - dx;
      rx[a] = bx + (int)dx;
      vx[a] = tap && dx >= lo && dx <= hi && rx[a] >= 0 && rx[a] < g.W && fabsf(tx) < 1.f;
      wx[t][a] = fmaxf(0.f, 1.f - fabsf(tx));
      dwx[t][a] = tx > 0.f ? -1.f : (tx < 0.f ? 1.f : 0.f);
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        on[t][a][bb] = vy[a] && vx[bb];
        corner[t][a][bb] = (b * g.H * g.W + (long long)ry[a] * g.W + rx[bb]) * KC +
                           (long long)k * g.Cout;
      }
  }

  const float* ctp = ct + pix * g.Cout;
  float s[kTaps][2][2] = {};
  for (int c = lane * VEC; c < g.Cout; c += 32 * VEC) {
    float cv[VEC];
    load_ct<VEC>(ctp + c, cv);
    float hv[kTaps][2][2][VEC];
#pragma unroll
    for (int t = 0; t < kTaps; ++t)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb)
          if (on[t][a][bb]) load_vec<T, VEC>(h + corner[t][a][bb] + c, hv[t][a][bb]);
#pragma unroll
    for (int t = 0; t < kTaps; ++t)
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          if (!on[t][a][bb]) continue;
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < VEC; ++i) d += cv[i] * hv[t][a][bb][i];
          s[t][a][bb] += d;
        }
  }
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    if (k0 + t >= g.K) continue;  // uniform across the warp
    float pdy = 0.f, pdx = 0.f, pdg = 0.f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        if (!on[t][a][bb]) continue;
        pdy += gg[t] * dwy[t][a] * wx[t][bb] * s[t][a][bb];
        pdx += gg[t] * wy[t][a] * dwx[t][bb] * s[t][a][bb];
        pdg += wy[t][a] * wx[t][bb] * s[t][a][bb];
      }
    }
    pdy = warp_sum(pdy);
    pdx = warp_sum(pdx);
    pdg = warp_sum(pdg);
    if (lane == 0) {
      doy[oidx[t]] = pdy;
      dox[oidx[t]] = pdx;
      if (dgate) dgate[oidx[t]] = pdg;
    }
  }
}

// One launch, two kinds of block: `dh_blocks` blocks of kBwdWarps d h
// strips, then blocks of kBwdWarps offset items. At most 128 registers a
// thread, so that two blocks share an SM.
template <typename T, int STRIDE, bool PADDED, int VEC>
__global__ void __launch_bounds__(kBwdThreads, 2)
window_taps_bwd_kernel(const T* __restrict__ h, const float* __restrict__ oy,
                       const float* __restrict__ ox, const float* __restrict__ gate,
                       const float* __restrict__ ct, T* __restrict__ dh,
                       float* __restrict__ doy, float* __restrict__ dox,
                       float* __restrict__ dgate, const BwdGeom g, long long dh_blocks) {
  const bool dh_kind = blockIdx.x < dh_blocks;
  const long long idx = dh_kind ? blockIdx.x : blockIdx.x - dh_blocks;
  const long long warp = idx * kBwdWarps + threadIdx.x / 32;
  if (dh_kind)
    dh_strip<T, STRIDE, PADDED, VEC>(oy, ox, gate, ct, dh, g, warp, threadIdx.x % 32);
  else
    offset_grads<T, STRIDE, PADDED, VEC>(h, oy, ox, gate, ct, doy, dox, dgate, g, warp,
                                         threadIdx.x % 32);
}

template <typename T, int STRIDE, bool PADDED, int VEC>
cudaError_t launch_bwd(const void* h, const float* oy, const float* ox, const float* gate,
                       const float* ct, void* dh, float* doy, float* dox, float* dgate,
                       int B, int H, int W, int Ho, int Wo, int K, int kw, int Cout, int m,
                       cudaStream_t stream) {
  const BwdGeom g{B, H, W, Ho, Wo, K, kw, Cout, m};
  const long long strips = (H + kStrip - 1) / kStrip;
  long long dh_blocks = (((long long)B * K * strips * W + kBwdWarps - 1) / kBwdWarps);
  const long long groups = (K + off_taps<VEC> - 1) / off_taps<VEC>;
  long long off_blocks = (((long long)B * Ho * Wo * groups + kBwdWarps - 1) / kBwdWarps);
  if (dh_blocks + off_blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  window_taps_bwd_kernel<T, STRIDE, PADDED, VEC><<<(unsigned)(dh_blocks + off_blocks),
                                                   kBwdThreads, 0, stream>>>(
      static_cast<const T*>(h), oy, ox, gate, ct, static_cast<T*>(dh), doy, dox, dgate, g,
      dh_blocks);
  return cudaGetLastError();
}

template <int STRIDE, bool PADDED>
cudaError_t dispatch_bwd(const void* h, const float* oy, const float* ox, const float* gate,
                         const float* ct, void* dh, float* doy, float* dox, float* dgate,
                         int B, int H, int W, int Ho, int Wo, int K, int kw, int Cout, int m,
                         int is_bf16, int vec, cudaStream_t s) {
  if (is_bf16) {
    if (vec == 8) return launch_bwd<__nv_bfloat16, STRIDE, PADDED, 8>(h, oy, ox, gate, ct, dh, doy, dox, dgate, B, H, W, Ho, Wo, K, kw, Cout, m, s);
    if (vec == 1) return launch_bwd<__nv_bfloat16, STRIDE, PADDED, 1>(h, oy, ox, gate, ct, dh, doy, dox, dgate, B, H, W, Ho, Wo, K, kw, Cout, m, s);
  } else {
    if (vec == 4) return launch_bwd<float, STRIDE, PADDED, 4>(h, oy, ox, gate, ct, dh, doy, dox, dgate, B, H, W, Ho, Wo, K, kw, Cout, m, s);
    if (vec == 1) return launch_bwd<float, STRIDE, PADDED, 1>(h, oy, ox, gate, ct, dh, doy, dox, dgate, B, H, W, Ho, Wo, K, kw, Cout, m, s);
  }
  return cudaErrorInvalidValue;
}

// The C entries' checks and dispatch. The unpadded map takes stride 1 or 2
// and a gate; the padded map stride 1, H = Ho + 2m + 1, W = Wo + 2m + 1,
// and a gate or none (null: g = 1, and no dgate).
template <bool PADDED>
bool bad_args(const void* gate, int B, int H, int W, int Ho, int Wo, int K, int kw, int Cout,
              int m, int stride, int vec) {
  if (B <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || K <= 0 || kw <= 0 || Cout <= 0 ||
      m < 0 || vec <= 0 || Cout % vec != 0)
    return true;
  if (PADDED) return stride != 1 || H != Ho + 2 * m + 1 || W != Wo + 2 * m + 1;
  return gate == nullptr || (stride != 1 && stride != 2);
}

template <bool PADDED>
int fwd_entry(const void* h, const void* oy, const void* ox, const void* gate, void* out, int B,
              int H, int W, int Ho, int Wo, int K, int kw, int Cout, int m, int stride,
              int is_bf16, int vec, void* stream) {
  if (bad_args<PADDED>(gate, B, H, W, Ho, Wo, K, kw, Cout, m, stride, vec))
    return (int)cudaErrorInvalidValue;
  const float* fy = static_cast<const float*>(oy);
  const float* fx = static_cast<const float*>(ox);
  const float* fg = static_cast<const float*>(gate);
  float* fo = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (!PADDED) {
    if (stride == 2)
      return (int)dispatch<2, false>(h, fy, fx, fg, fo, B, H, W, Ho, Wo, K, kw, Cout, m, is_bf16,
                                     vec, s);
  }
  return (int)dispatch<1, PADDED>(h, fy, fx, fg, fo, B, H, W, Ho, Wo, K, kw, Cout, m, is_bf16,
                                  vec, s);
}

template <bool PADDED>
int bwd_entry(const void* h, const void* oy, const void* ox, const void* gate, const void* ct,
              void* dh, void* doy, void* dox, void* dgate, int B, int H, int W, int Ho, int Wo,
              int K, int kw, int Cout, int m, int stride, int is_bf16, int vec, void* stream) {
  if (bad_args<PADDED>(gate, B, H, W, Ho, Wo, K, kw, Cout, m, stride, vec) ||
      (gate == nullptr) != (dgate == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* fy = static_cast<const float*>(oy);
  const float* fx = static_cast<const float*>(ox);
  const float* fg = static_cast<const float*>(gate);
  const float* fc = static_cast<const float*>(ct);
  float* gy = static_cast<float*>(doy);
  float* gx = static_cast<float*>(dox);
  float* gg = static_cast<float*>(dgate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (!PADDED) {
    if (stride == 2)
      return (int)dispatch_bwd<2, false>(h, fy, fx, fg, fc, dh, gy, gx, gg, B, H, W, Ho, Wo, K,
                                         kw, Cout, m, is_bf16, vec, s);
  }
  return (int)dispatch_bwd<1, PADDED>(h, fy, fx, fg, fc, dh, gy, gx, gg, B, H, W, Ho, Wo, K, kw,
                                      Cout, m, is_bf16, vec, s);
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream`, does
// not synchronise, allocates nothing, and returns cudaGetLastError() after
// the launch (or cudaErrorInvalidValue for arguments the kernel does not
// take).
//
// The unpadded map h [B, H, W, K*Cout] at stride 1 or 2 (rows 1f and 2f):
// oy, ox, gate [B, K, Ho, Wo] -> out [B, Ho, Wo, Cout] fp32.
extern "C" int lpi_window_taps_fwd(const void* h, const void* oy, const void* ox,
                                   const void* gate, void* out, int B, int H, int W,
                                   int Ho, int Wo, int K, int kw, int Cout, int m,
                                   int stride, int is_bf16, int vec, void* stream) {
  return fwd_entry<false>(h, oy, ox, gate, out, B, H, W, Ho, Wo, K, kw, Cout, m, stride, is_bf16,
                          vec, stream);
}

// Backward of `lpi_window_taps_fwd`: ct [B, Ho, Wo, Cout] fp32 -> dh (h's
// shape and type), doy, dox, dgate [B, K, Ho, Wo] fp32. One launch; every
// output element is written, so the outputs need no zero fill.
extern "C" int lpi_window_taps_bwd(const void* h, const void* oy, const void* ox,
                                   const void* gate, const void* ct, void* dh, void* doy,
                                   void* dox, void* dgate, int B, int H, int W, int Ho,
                                   int Wo, int K, int kw, int Cout, int m, int stride,
                                   int is_bf16, int vec, void* stream) {
  return bwd_entry<false>(h, oy, ox, gate, ct, dh, doy, dox, dgate, B, H, W, Ho, Wo, K, kw, Cout,
                          m, stride, is_bf16, vec, stream);
}

// The pre-shifted, pre-padded map hp [B, Ho+2m+1, Wo+2m+1, K*Cout] (rows 3
// and 4; H, W are its padded size, stride must be 1): the same arguments as
// `lpi_window_taps_fwd`, with `kw` unused and `gate` null for row 4.
extern "C" int lpi_window_padded_fwd(const void* hp, const void* oy, const void* ox,
                                     const void* gate, void* out, int B, int H, int W,
                                     int Ho, int Wo, int K, int kw, int Cout, int m,
                                     int stride, int is_bf16, int vec, void* stream) {
  return fwd_entry<true>(hp, oy, ox, gate, out, B, H, W, Ho, Wo, K, kw, Cout, m, stride, is_bf16,
                         vec, stream);
}

// Backward of `lpi_window_padded_fwd`: d hp over the whole padded map, pad
// ring included; `gate` and `dgate` both null for row 4.
extern "C" int lpi_window_padded_bwd(const void* hp, const void* oy, const void* ox,
                                     const void* gate, const void* ct, void* dhp, void* doy,
                                     void* dox, void* dgate, int B, int H, int W, int Ho,
                                     int Wo, int K, int kw, int Cout, int m, int stride,
                                     int is_bf16, int vec, void* stream) {
  return bwd_entry<true>(hp, oy, ox, gate, ct, dhp, doy, dox, dgate, B, H, W, Ho, Wo, K, kw,
                         Cout, m, stride, is_bf16, vec, stream);
}
