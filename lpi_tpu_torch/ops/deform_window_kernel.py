"""Gated 9-tap deform-window sums: CUDA kernels and their plain versions.

The matmul-first deformable conv (`ops/deform_conv.py`) multiplies the
features by all K tap weights at once, giving the tap-major product map
h_all [B, H, W, K*Cout]. What remains is the gated hat-window sum

    out[b,y,x,c] = sum_k g_k sum_{dy,dx in [-m, m+1]} hat(oy_k, dy)
                   * hat(ox_k, dx) * h_k[S*y + ky - 1 + dy, S*x + kx - 1 + dx, c]

with hat(o, d) = max(0, 1 - |o - d|), stride S, zero outside the map and
fp32 accumulation. Two entry points, each with its own launch counter:

* `window_accumulate_taps_inpad`: stride 1, replaces the Pallas TPU kernel
  `lpi_tpu/ops/deform_window_kernel.py:window_accumulate_taps_inpad`;
* `window_accumulate_taps_s2`: stride 2 on the UNPADDED map at input
  resolution, replaces `window_accumulate_taps_s2` there (whose four parity
  phases are a TPU layout device with no counterpart here).

The kernels live in `lpi_tpu_torch/csrc/deform_window.cu` (design and bound
in its header note). A wrapper takes its plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from lpi_tpu_torch.ops import cuda_build


def _hat(o: torch.Tensor, d: int) -> torch.Tensor:
    return torch.clamp(1.0 - (o - float(d)).abs(), min=0.0)


# --------------------------------------------------------------------------
# plain versions: the hat-sum loops of the JAX oracles
# --------------------------------------------------------------------------

def _tap_padded(h_all, k, Cout, m, kw):
    """Tap k's slab, zero-padded (m+1-ky, m+ky) x (m+1-kx, m+kx), so that
    window start (dy+m, dx+m) reads h_k[. + ky - 1 + dy, . + kx - 1 + dx]."""
    ky, kx = k // kw, k % kw
    h = h_all[..., k * Cout:(k + 1) * Cout]
    return F.pad(h, (0, 0, m + 1 - kx, m + kx, m + 1 - ky, m + ky))


def window_accumulate_taps_inpad_reference(h_all, oy, ox, gate, m: int,
                                           K: int, kw: int = 3):
    """Plain stride-1 version (`window_accumulate_taps_inpad_reference` and
    `window_accumulate_taps_reference` of the JAX package): h_all
    [B, H, W, K*Cout] unpadded; oy/ox/gate [B, K, H, W]; -> [B, H, W, Cout]
    fp32."""
    B, H, W, KC = h_all.shape
    Cout = KC // K
    out = torch.zeros((B, H, W, Cout), dtype=torch.float32, device=h_all.device)
    for k in range(K):
        hp = _tap_padded(h_all, k, Cout, m, kw)
        for dy in range(-m, m + 2):
            wy = _hat(oy[:, k], dy)
            for dx in range(-m, m + 2):
                coeff = gate[:, k] * wy * _hat(ox[:, k], dx)
                win = hp[:, dy + m:dy + m + H, dx + m:dx + m + W]
                out = out + coeff[..., None] * win.float()
    return out


def window_accumulate_taps_s2_reference(h_all, oy, ox, gate, m: int, K: int,
                                        kw: int = 3):
    """Plain stride-2 version (`window_accumulate_taps_s2_reference` of the
    JAX package, from the unpadded map): h_all [B, H, W, K*Cout] at input
    resolution; oy/ox/gate [B, K, Ho, Wo] at output resolution, Ho =
    ceil(H/2); -> [B, Ho, Wo, Cout] fp32."""
    B, H, W, KC = h_all.shape
    Cout = KC // K
    Ho, Wo = oy.shape[2], oy.shape[3]
    out = torch.zeros((B, Ho, Wo, Cout), dtype=torch.float32, device=h_all.device)
    for k in range(K):
        hp = _tap_padded(h_all, k, Cout, m, kw)
        for dy in range(-m, m + 2):
            wy = _hat(oy[:, k], dy)
            for dx in range(-m, m + 2):
                coeff = gate[:, k] * wy * _hat(ox[:, k], dx)
                win = hp[:, dy + m:dy + m + 2 * Ho - 1:2,
                         dx + m:dx + m + 2 * Wo - 1:2]
                out = out + coeff[..., None] * win.float()
    return out


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _check(h_all, oy, ox, gate, m, K, kw, stride):
    if h_all.dim() != 4 or oy.dim() != 4:
        raise ValueError(f"h_all must be [B,H,W,K*Cout] and offsets [B,K,Ho,Wo]; "
                         f"got {tuple(h_all.shape)} and {tuple(oy.shape)}")
    B, H, W, KC = h_all.shape
    if K <= 0 or kw <= 0 or K % kw or KC % K or KC == 0 or m < 0:
        raise ValueError(f"bad taps: K={K}, kw={kw}, m={m}, K*Cout={KC}")
    Ho, Wo = (H + stride - 1) // stride, (W + stride - 1) // stride
    want = (B, K, Ho, Wo)
    for name, t in (("oy", oy), ("ox", ox), ("gate", gate)):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != h_all.device:
            raise ValueError(f"{name} is on {t.device}, h_all on {h_all.device}")
    if h_all.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"h_all must be float32 or bfloat16, got {h_all.dtype}")
    if B * H * W == 0:
        raise ValueError("empty product map")
    return B, H, W, KC // K, Ho, Wo


@functools.cache
def _entry():
    """The kernel library's C entry point, built and typed at first use."""
    fn = cuda_build.load("deform_window").lpi_window_taps_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(h_all, oy, ox, gate, m, K, kw, stride):
    B, H, W, Cout, Ho, Wo = _check(h_all, oy, ox, gate, m, K, kw, stride)
    for name, t in (("h_all", h_all), ("oy", oy), ("ox", ox), ("gate", gate)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty((B, Ho, Wo, Cout), dtype=torch.float32, device=h_all.device)
    lanes = 16 // h_all.element_size()
    vec = lanes if Cout % lanes == 0 and h_all.data_ptr() % 16 == 0 else 1
    with torch.cuda.device(h_all.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry()(h_all.data_ptr(), oy.data_ptr(), ox.data_ptr(), gate.data_ptr(),
                       out.data_ptr(), B, H, W, Ho, Wo, K, kw, Cout, m, stride,
                       int(h_all.dtype == torch.bfloat16), vec, stream)
    if err != 0:
        raise RuntimeError(f"deform window kernel (stride {stride}) failed to "
                           f"launch: CUDA error {err}")
    return out


def _run(h_all, oy, ox, gate, m, K, kw, stride, reference):
    if h_all.device.type == "cpu":
        _check(h_all, oy, ox, gate, m, K, kw, stride)
        return reference(h_all, oy, ox, gate, m, K, kw)
    if h_all.device.type != "cuda":
        raise ValueError(f"no deform window kernel for device {h_all.device}")
    return _launch(h_all, oy, ox, gate, m, K, kw, stride)


def window_accumulate_taps_inpad(h_all, oy, ox, gate, m: int, K: int,
                                 kw: int = 3) -> torch.Tensor:
    """Stride-1 gated window sum from the unpadded product map.

    h_all [B, H, W, K*Cout] fp32 or bf16, contiguous; oy/ox/gate
    [B, K, H, W] fp32, offsets clamped to [-m, m]; -> [B, H, W, Cout] fp32.
    `window_accumulate_taps_inpad.launches` counts kernel launches.
    """
    out = _run(h_all, oy, ox, gate, m, K, kw, 1,
               window_accumulate_taps_inpad_reference)
    if h_all.device.type == "cuda":
        window_accumulate_taps_inpad.launches += 1
    return out


def window_accumulate_taps_s2(h_all, oy, ox, gate, m: int, K: int,
                              kw: int = 3) -> torch.Tensor:
    """Stride-2 gated window sum from the unpadded map at input resolution.

    h_all [B, H, W, K*Cout] fp32 or bf16, contiguous; oy/ox/gate
    [B, K, ceil(H/2), ceil(W/2)] fp32 at output resolution (offsets in
    input pixels, clamped to [-m, m]); -> [B, Ho, Wo, Cout] fp32.
    `window_accumulate_taps_s2.launches` counts kernel launches.
    """
    out = _run(h_all, oy, ox, gate, m, K, kw, 2,
               window_accumulate_taps_s2_reference)
    if h_all.device.type == "cuda":
        window_accumulate_taps_s2.launches += 1
    return out


window_accumulate_taps_inpad.launches = 0
window_accumulate_taps_s2.launches = 0
KERNELS = (window_accumulate_taps_inpad, window_accumulate_taps_s2)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
