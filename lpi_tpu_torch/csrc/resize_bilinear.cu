// Half-pixel bilinear upsample of NHWC maps (align_corners=False, no
// antialias), forward and backward, for the VLDyHead's level+1 path
// (`models/glip/vldyhead.py:DyConv`), written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package upsamples with
// `jax.image.resize(..., "bilinear")`, which XLA compiles. On the card the
// port called `F.interpolate`, whose backward under deterministic
// algorithms is PyTorch's decomposition: four gathers whose backward is a
// zero fill plus a sorted `index_put(accumulate=True)` each, about a quarter
// of the device time of a b16 grounding train step. These kernels compute
// the same function in one pass each way, with no atomics, no sort, no fill
// and no index tensors.
//
// Taps. Along an axis of `in` inputs and `out` >= `in` outputs, output j
// reads inputs i0 and i1 with weights l0 and l1:
//
//   scale = in / out (fp32), src = max(scale * (j + 0.5) - 0.5, 0),
//   i0 = floor(src), i1 = min(i0 + 1, in - 1), l1 = src - i0, l0 = 1 - l1,
//
// PyTorch's `align_corners=False` rule, each operation rounded on its own
// (no fused multiply-add), as the CPU computes it. `tap_of` is the one
// place both kernels take them from, so the backward is the exact adjoint of
// the forward's taps and weights.
//
// Forward (`lpi_resize_bilinear_fwd`): x [B, h, w, C] -> y [B, H, W, C],
// fp32 or bf16. One thread owns VEC neighbouring channels of one output
// pixel (VEC = 8 for bf16, 4 for fp32: one 16-byte load per corner, where C
// and the pointers allow; else 1), reads its four corners, interpolates in
// fp32 (along each of the two rows, then between them) and rounds once to
// the map's type.
//
// Backward, gather form (`lpi_resize_bilinear_bwd`): dy [B, H, W, C] -> dx
// [B, h, w, C] in the same type. i0(j) is monotone in j, so the outputs
// that read input i (through i0 or i1: i0(j) in {i - 1, i}) form one
// contiguous range of j per axis, found from the rule's inverse and
// corrected by `tap_of` itself. One thread owns VEC channels of one input pixel, walks its rows'
// range, then its columns', in ascending order, adds w_y * w_x * dy in fp32
// and writes its element once, rounded once. Every element of dx is written,
// so it needs no zero fill; two calls give equal bits.
//
// Bound on an H100 (3.35 TB/s): bytes. At the b16 train step (448 px, bf16,
// C = 256) the four levels 28->56, 14->28, 7->14 and 4->7 of one tower read
// 8.6 MB and write 34.1 MB forward, and the reverse backward: about 13 us a
// tower each way, 0.077 ms a step of 6 towers each way. The arithmetic (4
// or 16 fused multiply-adds an element) is far under it. Neighbouring
// threads take neighbouring channel groups of one pixel, so a warp's loads
// and stores are contiguous; the backward's re-reads of dy (each output row
// is read by the 2 x 2 input pixels around it at 2x) come from L1 and L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_float(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

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

struct Tap {
  int i0, i1;
  float l0, l1;
};

// The source taps of output index j along an axis of `in` inputs, `scale`
// = in / out.
__device__ __forceinline__ Tap tap_of(int j, int in, float scale) {
  const float src = fmaxf(__fsub_rn(__fmul_rn(scale, __fadd_rn((float)j, 0.5f)), 0.5f), 0.f);
  Tap t;
  t.i0 = min((int)src, in - 1);
  t.i1 = min(t.i0 + 1, in - 1);
  t.l1 = __fsub_rn(src, (float)t.i0);
  t.l0 = __fsub_rn(1.f, t.l1);
  return t;
}

// The weight with which output j (taps t) reads input i: 0 unless i is
// one of its taps; both at the last input, where i0 = i1.
__device__ __forceinline__ float weight_of(const Tap& t, int i) {
  return (t.i0 == i ? t.l0 : 0.f) + (t.i1 == i ? t.l1 : 0.f);
}

// The first output index in [0, out] whose i0 is at least `target`:
// src(j) >= target from the rule's inverse, then moved until `tap_of`
// itself agrees (a step or none), so the range is exact whatever the
// inverse's rounding.
__device__ __forceinline__ int first_reading(int target, int in, int out, float scale) {
  if (target <= 0) return 0;
  int j = min(max((int)ceilf(((float)target + 0.5f) / scale - 0.5f), 0), out);
  while (j > 0 && tap_of(j - 1, in, scale).i0 >= target) --j;
  while (j < out && tap_of(j, in, scale).i0 < target) ++j;
  return j;
}

struct Geom {
  int B, h, w, H, W, C;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
resize_bilinear_fwd_kernel(const T* __restrict__ x, T* __restrict__ y, Geom g) {
  const int groups = g.C / VEC;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= g.B * g.H * g.W * groups) return;
  const int c = t % groups * VEC;
  int p = t / groups;
  const int ox = p % g.W;
  p /= g.W;
  const int oy = p % g.H;
  const long long b = p / g.H;
  const Tap ty = tap_of(oy, g.h, __fdiv_rn((float)g.h, (float)g.H));
  const Tap tx = tap_of(ox, g.w, __fdiv_rn((float)g.w, (float)g.W));
  const T* xb = x + b * g.h * g.w * g.C + c;
  float a[VEC], bb[VEC], cc[VEC], d[VEC], out[VEC];
  load_vec<T, VEC>(xb + ((long long)ty.i0 * g.w + tx.i0) * g.C, a);
  load_vec<T, VEC>(xb + ((long long)ty.i0 * g.w + tx.i1) * g.C, bb);
  load_vec<T, VEC>(xb + ((long long)ty.i1 * g.w + tx.i0) * g.C, cc);
  load_vec<T, VEC>(xb + ((long long)ty.i1 * g.w + tx.i1) * g.C, d);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float top = fmaf(tx.l1, bb[i], tx.l0 * a[i]);
    const float bot = fmaf(tx.l1, d[i], tx.l0 * cc[i]);
    out[i] = fmaf(ty.l1, bot, ty.l0 * top);
  }
  store_vec<T, VEC>(y + (long long)t * VEC, out);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
resize_bilinear_bwd_kernel(const T* __restrict__ dy, T* __restrict__ dx, Geom g) {
  const int groups = g.C / VEC;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= g.B * g.h * g.w * groups) return;
  const int c = t % groups * VEC;
  int p = t / groups;
  const int ix = p % g.w;
  p /= g.w;
  const int iy = p % g.h;
  const long long b = p / g.h;
  const float sy = __fdiv_rn((float)g.h, (float)g.H), sx = __fdiv_rn((float)g.w, (float)g.W);
  const int y0 = first_reading(iy - 1, g.h, g.H, sy), y1 = first_reading(iy + 1, g.h, g.H, sy);
  const int x0 = first_reading(ix - 1, g.w, g.W, sx), x1 = first_reading(ix + 1, g.w, g.W, sx);
  const T* db = dy + b * g.H * g.W * g.C + c;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int oy = y0; oy < y1; ++oy) {
    const float wy = weight_of(tap_of(oy, g.h, sy), iy);
    for (int ox = x0; ox < x1; ++ox) {
      const float wgt = wy * weight_of(tap_of(ox, g.w, sx), ix);
      float v[VEC];
      load_vec<T, VEC>(db + ((long long)oy * g.W + ox) * g.C, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wgt, v[i], acc[i]);
    }
  }
  store_vec<T, VEC>(dx + (long long)t * VEC, acc);
}

template <typename T, int VEC>
cudaError_t launch(bool backward, const void* src, void* dst, const Geom& g, cudaStream_t s) {
  const long long pixels = backward ? (long long)g.B * g.h * g.w : (long long)g.B * g.H * g.W;
  const long long threads = pixels * (g.C / VEC);  // indexed in 32 bits in the kernels
  if (threads > 2147483647LL - kThreads) return cudaErrorInvalidConfiguration;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (backward)
    resize_bilinear_bwd_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const T*>(src), static_cast<T*>(dst), g);
  else
    resize_bilinear_fwd_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const T*>(src), static_cast<T*>(dst), g);
  return cudaGetLastError();
}

int entry(bool backward, const void* src, void* dst, int B, int h, int w, int H, int W, int C,
          int is_bf16, int vec, void* stream) {
  if (B <= 0 || h <= 0 || w <= 0 || H < h || W < w || C <= 0 || vec <= 0 || C % vec != 0)
    return (int)cudaErrorInvalidValue;
  const Geom g{B, h, w, H, W, C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (vec == 8) return (int)launch<__nv_bfloat16, 8>(backward, src, dst, g, s);
    if (vec == 1) return (int)launch<__nv_bfloat16, 1>(backward, src, dst, g, s);
  } else {
    if (vec == 4) return (int)launch<float, 4>(backward, src, dst, g, s);
    if (vec == 1) return (int)launch<float, 1>(backward, src, dst, g, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Each launches on `stream`, does
// not synchronise, allocates nothing, and returns cudaGetLastError() after
// the launch (or cudaErrorInvalidValue for arguments the kernel does not
// take: a downsample, C not a multiple of vec, vec other than 8 / 4 / 1).
//
// x [B, h, w, C] -> y [B, H, W, C], H >= h, W >= w, contiguous, fp32
// (is_bf16 = 0) or bf16.
extern "C" int lpi_resize_bilinear_fwd(const void* x, void* y, int B, int h, int w, int H,
                                       int W, int C, int is_bf16, int vec, void* stream) {
  return entry(false, x, y, B, h, w, H, W, C, is_bf16, vec, stream);
}

// Backward of `lpi_resize_bilinear_fwd`: dy [B, H, W, C] -> dx [B, h, w, C],
// the same type; every element of dx is written.
extern "C" int lpi_resize_bilinear_bwd(const void* dy, void* dx, int B, int h, int w, int H,
                                       int W, int C, int is_bf16, int vec, void* stream) {
  return entry(true, dy, dx, B, h, w, H, W, C, is_bf16, vec, stream);
}
