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
// Thread mapping: one thread owns VEC neighbouring output channels of one
// output pixel (VEC = 8 for bf16, 4 for fp32: one 16-byte load per corner);
// neighbouring threads take neighbouring channel groups of the same pixel, so
// the corner reads of a warp are contiguous in the NHWC, tap-major h_all. The
// pixel's 9 (oy, ox, g) triples are warp-uniform loads. Accumulation is fp32
// in registers; the output is written once, fp32.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor cores): the
// floor is one read of h_all plus the offsets and one write of out. At P3 of
// the 448 px slice (56x56, K*Cout = 2304, bf16) that is 14.5 MB + 0.3 MB +
// 3.2 MB, about 5.3 us; the arithmetic (4 corners x 9 taps x 2 flops per
// output value) is under 1 us. So the kernel is bound by bytes. Corners are
// re-read by up to four neighbouring pixels; those re-reads hit L1/L2 (the
// whole P3 map fits in the 50 MB L2). Shared-memory tiling and TMA are later
// work.

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

template <typename T, int STRIDE, int VEC>
__global__ void __launch_bounds__(256)
window_taps_kernel(const T* __restrict__ h, const float* __restrict__ oy,
                   const float* __restrict__ ox, const float* __restrict__ gate,
                   float* __restrict__ out, int H, int W, int Ho, int Wo, int K,
                   int kw, int Cout, int m, long long npix) {
  const int groups = Cout / VEC;
  const int cg = blockIdx.y * blockDim.x + threadIdx.x;
  const long long pix = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (cg >= groups || pix >= npix) return;

  const int xo = (int)(pix % Wo);
  const long long rest = pix / Wo;
  const int yo = (int)(rest % Ho);
  const long long b = rest / Ho;
  const int c0 = cg * VEC;
  const long long KC = (long long)K * Cout;
  const long long plane = (long long)Ho * Wo;
  const long long obase = b * K * plane + (long long)yo * Wo + xo;
  const T* hb = h + b * H * W * KC + c0;
  const float lo = (float)(-m), hi = (float)(m + 1);

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  for (int k = 0; k < K; ++k) {
    const float o_y = __ldg(oy + obase + k * plane);
    const float o_x = __ldg(ox + obase + k * plane);
    const float g = __ldg(gate + obase + k * plane);
    const float fy = floorf(o_y), fx = floorf(o_x);
    const int by = STRIDE * yo + k / kw - 1;
    const int bx = STRIDE * xo + k % kw - 1;
    const T* hk = hb + (long long)k * Cout;
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
        float v[VEC];
        load_vec<T, VEC>(hk + ((long long)iy * W + ix) * KC, v);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += c * v[i];
      }
    }
  }

  float* o = out + pix * Cout + c0;
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(o + i) = make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = acc[i];
  }
}

template <typename T, int STRIDE, int VEC>
cudaError_t launch(const void* h, const float* oy, const float* ox, const float* gate,
                   float* out, int B, int H, int W, int Ho, int Wo, int K, int kw,
                   int Cout, int m, cudaStream_t stream) {
  const int groups = Cout / VEC;
  const int bx = groups < 256 ? groups : 256;
  const int by = 256 / bx > 0 ? 256 / bx : 1;
  const long long npix = (long long)B * Ho * Wo;
  const long long gx = (npix + by - 1) / by;
  if (gx > 2147483647LL) return cudaErrorInvalidConfiguration;
  dim3 block(bx, by);
  dim3 grid((unsigned)gx, (unsigned)((groups + bx - 1) / bx));
  window_taps_kernel<T, STRIDE, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(h), oy, ox, gate, out, H, W, Ho, Wo, K, kw, Cout, m, npix);
  return cudaGetLastError();
}

template <int STRIDE>
cudaError_t dispatch(const void* h, const float* oy, const float* ox, const float* gate,
                     float* out, int B, int H, int W, int Ho, int Wo, int K, int kw,
                     int Cout, int m, int is_bf16, int vec, cudaStream_t s) {
  if (is_bf16) {
    if (vec == 8) return launch<__nv_bfloat16, STRIDE, 8>(h, oy, ox, gate, out, B, H, W, Ho, Wo, K, kw, Cout, m, s);
    if (vec == 1) return launch<__nv_bfloat16, STRIDE, 1>(h, oy, ox, gate, out, B, H, W, Ho, Wo, K, kw, Cout, m, s);
  } else {
    if (vec == 4) return launch<float, STRIDE, 4>(h, oy, ox, gate, out, B, H, W, Ho, Wo, K, kw, Cout, m, s);
    if (vec == 1) return launch<float, STRIDE, 1>(h, oy, ox, gate, out, B, H, W, Ho, Wo, K, kw, Cout, m, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on `stream`, does not
// synchronise, allocates nothing; returns cudaGetLastError() after the launch
// (or cudaErrorInvalidValue for arguments the kernel does not take).
extern "C" int lpi_window_taps_fwd(const void* h, const void* oy, const void* ox,
                                   const void* gate, void* out, int B, int H, int W,
                                   int Ho, int Wo, int K, int kw, int Cout, int m,
                                   int stride, int is_bf16, int vec, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 || K <= 0 || kw <= 0 ||
      Cout <= 0 || m < 0 || Cout % vec != 0)
    return (int)cudaErrorInvalidValue;
  const float* fy = static_cast<const float*>(oy);
  const float* fx = static_cast<const float*>(ox);
  const float* fg = static_cast<const float*>(gate);
  float* fo = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride == 1)
    return (int)dispatch<1>(h, fy, fx, fg, fo, B, H, W, Ho, Wo, K, kw, Cout, m, is_bf16, vec, s);
  if (stride == 2)
    return (int)dispatch<2>(h, fy, fx, fg, fo, B, H, W, Ho, Wo, K, kw, Cout, m, is_bf16, vec, s);
  return (int)cudaErrorInvalidValue;
}
