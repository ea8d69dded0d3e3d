"""Gated 9-tap deform-window sums: CUDA kernels and their plain versions.

The matmul-first deformable conv (`ops/deform_conv.py`) multiplies the
features by all K tap weights at once, giving the tap-major product map
h_all [B, H, W, K*Cout]. What remains is the gated hat-window sum

    out[b,y,x,c] = sum_k g_k sum_{dy,dx in [-m, m+1]} hat(oy_k, dy)
                   * hat(ox_k, dx) * h_k[S*y + ky - 1 + dy, S*x + kx - 1 + dx, c]

with hat(o, d) = max(0, 1 - |o - d|), stride S, zero outside the map and
fp32 accumulation. Eight entry points, each with its own launch counter:

* `window_accumulate_taps_inpad`: stride 1, replaces the Pallas TPU kernel
  `lpi_tpu/ops/deform_window_kernel.py:window_accumulate_taps_inpad`;
* `window_accumulate_taps_s2`: stride 2 on the UNPADDED map at input
  resolution, replaces `window_accumulate_taps_s2` there (whose four parity
  phases are a TPU layout device with no counterpart here);
* `window_accumulate_taps_inpad_backward` and
  `window_accumulate_taps_s2_backward`: their VJPs (the Pallas kernels
  `_bwd_taps_inpad_kernel` and `_bwd_taps_s2_kernel`), giving d h_all in
  h_all's dtype and d oy, d ox, d gate in fp32;
* `window_accumulate_taps` and `window_accumulate_taps_backward`: the same
  gated sum at stride 1 over a PRE-SHIFTED, PRE-PADDED map hp_all
  [B, Ho+2m+1, Wo+2m+1, K*Cout], tap k reading hp_k[y + m + dy, x + m + dx]
  (`window_accumulate_taps` of the JAX package and its VJP);
* `window_accumulate` and `window_accumulate_backward`: the single padded
  map hp [B, Ho+2m+1, Wo+2m+1, C], fp32 only, no gate and no taps
  (`window_accumulate` of the JAX package and its VJP).

The padded VJPs return d hp over the whole padded map, pad ring included,
as the JAX VJPs do. `window_taps` (both strides of the unpadded map),
`window_taps_padded` and `window_single` are the differentiable entries:
`torch.autograd.Function`s whose forward and backward are the wrappers
above.

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


def _dhat(o: torch.Tensor, d: int) -> torch.Tensor:
    """d/do hat(o, d): -sign(o - d) where |o - d| < 1, else 0."""
    t = o - float(d)
    return torch.where(t.abs() < 1.0, -torch.sign(t), torch.zeros_like(t))


# --------------------------------------------------------------------------
# plain versions: the hat-sum loops of the JAX oracles
# --------------------------------------------------------------------------

def _tap_padded(h_all, k, Cout, m, kw):
    """Tap k's slab, zero-padded (m+1-ky, m+ky) x (m+1-kx, m+kx), so that
    window start (dy+m, dx+m) reads h_k[. + ky - 1 + dy, . + kx - 1 + dx]."""
    ky, kx = k // kw, k % kw
    h = h_all[..., k * Cout:(k + 1) * Cout]
    return F.pad(h, (0, 0, m + 1 - kx, m + kx, m + 1 - ky, m + ky))


def _add_window_sums(out, hp, oy, ox, g, m, Ho, Wo, stride=1):
    """out + sum_{dy,dx} g hat(oy, dy) hat(ox, dx) hp[S*y + dy + m, S*x + dx + m]
    for one padded slab hp [B, ., ., C], added term by term in the hat sum's
    order (dy, then dx ascending); g None is a gate of 1."""
    span_y, span_x = stride * (Ho - 1) + 1, stride * (Wo - 1) + 1
    hp = hp.float()
    wxs = [_hat(ox, dx) for dx in range(-m, m + 2)]
    for dy in range(-m, m + 2):
        wy = _hat(oy, dy)
        gwy = wy if g is None else g * wy  # the same products, formed once a row
        for dx, wx in zip(range(-m, m + 2), wxs):
            win = hp[:, dy + m:dy + m + span_y:stride, dx + m:dx + m + span_x:stride]
            out = out + (gwy * wx)[..., None] * win
    return out


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
        out = _add_window_sums(out, hp, oy[:, k], ox[:, k], gate[:, k], m, H, W)
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
        out = _add_window_sums(out, hp, oy[:, k], ox[:, k], gate[:, k], m, Ho, Wo, 2)
    return out


def window_accumulate_taps_reference(hp_all, oy, ox, gate, m: int, K: int):
    """Plain version of the pre-padded sum (`window_accumulate_taps_reference`
    of the JAX package): hp_all [B, Ho+2m+1, Wo+2m+1, K*Cout], each tap's
    (ky, kx) shift baked into its pad; oy/ox/gate [B, K, Ho, Wo] (gate None:
    1); -> [B, Ho, Wo, Cout] fp32."""
    B, Hp, Wp, KC = hp_all.shape
    Cout = KC // K
    Ho, Wo = Hp - 2 * m - 1, Wp - 2 * m - 1
    out = torch.zeros((B, Ho, Wo, Cout), dtype=torch.float32, device=hp_all.device)
    for k in range(K):
        g = None if gate is None else gate[:, k]
        out = _add_window_sums(out, hp_all[..., k * Cout:(k + 1) * Cout], oy[:, k], ox[:, k],
                               g, m, Ho, Wo)
    return out


def window_accumulate_reference(hp, oy, ox, m: int):
    """Plain version of the single-map sum (`window_accumulate_reference` of
    the JAX package): hp [B, Ho+2m+1, Wo+2m+1, C] fp32, oy/ox [B, Ho, Wo];
    no gate; -> [B, Ho, Wo, C] fp32."""
    return window_accumulate_taps_reference(hp, oy[:, None], ox[:, None], None, m, 1)


def _backward_reference(h_all, oy, ox, gate, ct, m, K, kw, stride, padded=False):
    """The VJP as the JAX package's `_bwd_reference` loops it, with the gate
    and each tap's shifted padding (or, `padded`, on the map as given, whose
    d covers the pad ring): every displacement adds its window's terms; fp32
    sums, d h_all cast to h_all's dtype once. gate None is a gate of 1, and
    its gradient is None."""
    B, H, W, KC = h_all.shape
    Cout = KC // K
    Ho, Wo = oy.shape[2], oy.shape[3]
    span_y, span_x = stride * (Ho - 1) + 1, stride * (Wo - 1) + 1
    ct = ct.float()
    dh = torch.empty((B, H, W, KC), dtype=torch.float32, device=h_all.device)
    doy, dox, dg = (torch.zeros((B, K, Ho, Wo), dtype=torch.float32,
                                device=h_all.device) for _ in range(3))
    for k in range(K):
        ky, kx = k // kw, k % kw
        hp = (h_all[..., k * Cout:(k + 1) * Cout] if padded
              else _tap_padded(h_all, k, Cout, m, kw)).float()
        dhp = torch.zeros_like(hp)
        g = 1.0 if gate is None else gate[:, k]
        xs = [(dx, _hat(ox[:, k], dx), _dhat(ox[:, k], dx)) for dx in range(-m, m + 2)]
        for dy in range(-m, m + 2):
            wy, gy = _hat(oy[:, k], dy), _dhat(oy[:, k], dy)
            ggy, gwy = g * gy, g * wy  # the same products, formed once a row
            rows = slice(dy + m, dy + m + span_y, stride)
            for dx, wx, gx in xs:
                cols = slice(dx + m, dx + m + span_x, stride)
                s = (ct * hp[:, rows, cols]).sum(-1)
                doy[:, k] += ggy * wx * s
                dox[:, k] += gwy * gx * s
                dg[:, k] += wy * wx * s
                dhp[:, rows, cols] += (gwy * wx)[..., None] * ct
        dh[..., k * Cout:(k + 1) * Cout] = (dhp if padded else
                                            dhp[:, m + 1 - ky:m + 1 - ky + H,
                                                m + 1 - kx:m + 1 - kx + W])
    return dh.to(h_all.dtype), doy, dox, (None if gate is None else dg)


def window_accumulate_taps_inpad_backward_reference(h_all, oy, ox, gate, ct,
                                                    m: int, K: int, kw: int = 3):
    """Plain VJP of the stride-1 sum: ct [B, H, W, Cout] fp32 -> (d h_all in
    h_all's dtype, d oy, d ox, d gate [B, K, H, W] fp32)."""
    return _backward_reference(h_all, oy, ox, gate, ct, m, K, kw, 1)


def window_accumulate_taps_s2_backward_reference(h_all, oy, ox, gate, ct,
                                                 m: int, K: int, kw: int = 3):
    """Plain VJP of the stride-2 sum: ct [B, Ho, Wo, Cout] fp32 -> (d h_all
    [B, H, W, K*Cout] of the unpadded map, d oy, d ox, d gate [B, K, Ho, Wo])."""
    return _backward_reference(h_all, oy, ox, gate, ct, m, K, kw, 2)


def window_accumulate_taps_backward_reference(hp_all, oy, ox, gate, ct, m: int, K: int):
    """Plain VJP of the pre-padded sum, as the Pallas VJP computes it (the
    `_dhat` rule: 0 at an integer offset): ct [B, Ho, Wo, Cout] fp32 ->
    (d hp_all over the whole padded map in hp_all's dtype, d oy, d ox,
    d gate [B, K, Ho, Wo] fp32; d gate None when gate is None)."""
    return _backward_reference(hp_all, oy, ox, gate, ct, m, K, 1, 1, padded=True)


def window_accumulate_backward_reference(hp, oy, ox, ct, m: int):
    """Plain VJP of the single-map sum: ct [B, Ho, Wo, C] fp32 -> (d hp,
    d oy, d ox [B, Ho, Wo]), fp32."""
    dhp, doy, dox, _ = window_accumulate_taps_backward_reference(
        hp, oy[:, None], ox[:, None], None, ct, m, 1)
    return dhp, doy[:, 0], dox[:, 0]


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _check(h_all, oy, ox, gate, m, K, kw, stride, padded=False):
    """Shapes, types and devices the kernels take. `padded`: h_all is the
    pre-padded map [B, Ho+2m+1, Wo+2m+1, K*Cout] at stride 1, whose gate may
    be None; else the unpadded map at stride 1 or 2."""
    if h_all.dim() != 4 or oy.dim() != 4:
        raise ValueError(f"h_all must be [B,H,W,K*Cout] and offsets [B,K,Ho,Wo]; "
                         f"got {tuple(h_all.shape)} and {tuple(oy.shape)}")
    B, H, W, KC = h_all.shape
    if K <= 0 or kw <= 0 or K % kw or KC % K or KC == 0 or m < 0:
        raise ValueError(f"bad taps: K={K}, kw={kw}, m={m}, K*Cout={KC}")
    if padded:
        Ho, Wo = H - 2 * m - 1, W - 2 * m - 1
    else:
        Ho, Wo = (H + stride - 1) // stride, (W + stride - 1) // stride
    want = (B, K, Ho, Wo)
    if gate is None and not padded:
        raise ValueError("the unpadded window sums take a gate")
    for name, t in (("oy", oy), ("ox", ox), ("gate", gate)):
        if t is None:
            continue
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want}"
                             + (" (the padded map is [B, Ho+2m+1, Wo+2m+1, K*Cout])"
                                if padded else ""))
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != h_all.device:
            raise ValueError(f"{name} is on {t.device}, h_all on {h_all.device}")
    if h_all.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"h_all must be float32 or bfloat16, got {h_all.dtype}")
    if B == 0 or Ho <= 0 or Wo <= 0:
        raise ValueError("empty product map")
    return B, H, W, KC // K, Ho, Wo


@functools.cache
def _entry(name: str):
    """The kernel library's C entry point `name`, built and typed at first
    use: `lpi_window_{taps,padded}_{fwd,bwd}`."""
    fn = getattr(cuda_build.load("deform_window"), name)
    pointers = 9 if name.endswith("_bwd") else 5
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _contiguous(**tensors):
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _what(stride, padded):
    return "padded deform window" if padded else f"deform window (stride {stride})"


def _launch(h_all, oy, ox, gate, m, K, kw, stride, padded):
    B, H, W, Cout, Ho, Wo = _check(h_all, oy, ox, gate, m, K, kw, stride, padded)
    _contiguous(h_all=h_all, oy=oy, ox=ox, gate=gate)
    out = torch.empty((B, Ho, Wo, Cout), dtype=torch.float32, device=h_all.device)
    lanes = 16 // h_all.element_size()
    vec = lanes if Cout % lanes == 0 and h_all.data_ptr() % 16 == 0 else 1
    entry = _entry("lpi_window_padded_fwd" if padded else "lpi_window_taps_fwd")
    with torch.cuda.device(h_all.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(h_all.data_ptr(), oy.data_ptr(), ox.data_ptr(), _ptr(gate),
                    out.data_ptr(), B, H, W, Ho, Wo, K, kw, Cout, m, stride,
                    int(h_all.dtype == torch.bfloat16), vec, stream)
    if err != 0:
        raise RuntimeError(f"{_what(stride, padded)} kernel failed to launch: CUDA error {err}")
    return out


def _run(h_all, oy, ox, gate, m, K, kw, stride, reference, padded=False):
    if h_all.device.type == "cpu":
        _check(h_all, oy, ox, gate, m, K, kw, stride, padded)
        if padded:
            return reference(h_all, oy, ox, gate, m, K)
        return reference(h_all, oy, ox, gate, m, K, kw)
    if h_all.device.type != "cuda":
        raise ValueError(f"no deform window kernel for device {h_all.device}")
    return _launch(h_all, oy, ox, gate, m, K, kw, stride, padded)


def _check_ct(ct, B, Ho, Wo, Cout, device):
    if tuple(ct.shape) != (B, Ho, Wo, Cout):
        raise ValueError(f"ct has shape {tuple(ct.shape)}, want {(B, Ho, Wo, Cout)}")
    if ct.dtype != torch.float32:
        raise TypeError(f"ct must be float32, got {ct.dtype}")
    if ct.device != device:
        raise ValueError(f"ct is on {ct.device}, h_all on {device}")


def _launch_backward(h_all, oy, ox, gate, ct, m, K, kw, stride, padded):
    B, H, W, Cout, Ho, Wo = _check(h_all, oy, ox, gate, m, K, kw, stride, padded)
    _check_ct(ct, B, Ho, Wo, Cout, h_all.device)
    _contiguous(h_all=h_all, oy=oy, ox=ox, gate=gate, ct=ct)
    dh = torch.empty_like(h_all)
    doy, dox = torch.empty_like(oy), torch.empty_like(ox)
    dg = None if gate is None else torch.empty_like(gate)
    lanes = 16 // h_all.element_size()
    vec = (lanes if Cout % lanes == 0 and h_all.data_ptr() % 16 == 0
           and ct.data_ptr() % 16 == 0 else 1)
    entry = _entry("lpi_window_padded_bwd" if padded else "lpi_window_taps_bwd")
    with torch.cuda.device(h_all.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(h_all.data_ptr(), oy.data_ptr(), ox.data_ptr(), _ptr(gate),
                    ct.data_ptr(), dh.data_ptr(), doy.data_ptr(), dox.data_ptr(),
                    _ptr(dg), B, H, W, Ho, Wo, K, kw, Cout, m, stride,
                    int(h_all.dtype == torch.bfloat16), vec, stream)
    if err != 0:
        raise RuntimeError(f"{_what(stride, padded)} backward kernel failed to launch: "
                           f"CUDA error {err}")
    return dh, doy, dox, dg


def _run_backward(h_all, oy, ox, gate, ct, m, K, kw, stride, reference, padded=False):
    if h_all.device.type == "cpu":
        B, _, _, Cout, Ho, Wo = _check(h_all, oy, ox, gate, m, K, kw, stride, padded)
        _check_ct(ct, B, Ho, Wo, Cout, h_all.device)
        if padded:
            return reference(h_all, oy, ox, gate, ct, m, K)
        return reference(h_all, oy, ox, gate, ct, m, K, kw)
    if h_all.device.type != "cuda":
        raise ValueError(f"no deform window kernel for device {h_all.device}")
    return _launch_backward(h_all, oy, ox, gate, ct, m, K, kw, stride, padded)


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


def window_accumulate_taps_inpad_backward(h_all, oy, ox, gate, ct, m: int, K: int,
                                          kw: int = 3):
    """VJP of `window_accumulate_taps_inpad`: ct [B, H, W, Cout] fp32,
    contiguous -> (d h_all in h_all's shape and dtype, d oy, d ox, d gate
    [B, K, H, W] fp32). `.launches` counts kernel launches."""
    out = _run_backward(h_all, oy, ox, gate, ct, m, K, kw, 1,
                        window_accumulate_taps_inpad_backward_reference)
    if h_all.device.type == "cuda":
        window_accumulate_taps_inpad_backward.launches += 1
    return out


def window_accumulate_taps_s2_backward(h_all, oy, ox, gate, ct, m: int, K: int,
                                       kw: int = 3):
    """VJP of `window_accumulate_taps_s2`: ct [B, Ho, Wo, Cout] fp32,
    contiguous -> (d h_all of the unpadded map, d oy, d ox, d gate
    [B, K, Ho, Wo] fp32). `.launches` counts kernel launches."""
    out = _run_backward(h_all, oy, ox, gate, ct, m, K, kw, 2,
                        window_accumulate_taps_s2_backward_reference)
    if h_all.device.type == "cuda":
        window_accumulate_taps_s2_backward.launches += 1
    return out


class _WindowTaps(torch.autograd.Function):
    """Forward and backward through the wrappers: the kernels for CUDA
    tensors, the plain versions for CPU tensors."""

    @staticmethod
    def forward(ctx, h_all, oy, ox, gate, m, K, kw, stride):
        ctx.save_for_backward(h_all, oy, ox, gate)
        ctx.taps = (m, K, kw, stride)
        fwd = window_accumulate_taps_inpad if stride == 1 else window_accumulate_taps_s2
        return fwd(h_all, oy, ox, gate, m, K, kw)

    @staticmethod
    def backward(ctx, ct):
        m, K, kw, stride = ctx.taps
        bwd = (window_accumulate_taps_inpad_backward if stride == 1
               else window_accumulate_taps_s2_backward)
        # autograd may hand over a strided cotangent; the kernel takes none
        grads = bwd(*ctx.saved_tensors, ct.contiguous(), m, K, kw)
        return (*grads, None, None, None, None)


def window_taps(h_all, oy, ox, gate, m: int, K: int, kw: int = 3,
                stride: int = 1) -> torch.Tensor:
    """Differentiable gated window sum, stride 1 or 2: the arguments and
    result of `window_accumulate_taps_inpad` / `window_accumulate_taps_s2`,
    with gradients for h_all, oy, ox and gate."""
    if stride not in (1, 2):
        raise ValueError(f"window_taps supports stride 1 and 2, got {stride}")
    return _WindowTaps.apply(h_all, oy, ox, gate, m, K, kw, stride)


# --------------------------------------------------------------------------
# the pre-padded sums: rows 3 and 4 of the JAX package's kernels
# --------------------------------------------------------------------------

def window_accumulate_taps(hp_all, oy, ox, gate, m: int, K: int) -> torch.Tensor:
    """Gated K-tap window sum over the pre-shifted, pre-padded map.

    hp_all [B, Ho+2m+1, Wo+2m+1, K*Cout] fp32 or bf16, contiguous, each
    tap's (ky, kx) shift baked into its pad; oy/ox/gate [B, K, Ho, Wo] fp32,
    offsets clamped to [-m, m]; -> [B, Ho, Wo, Cout] fp32.
    `window_accumulate_taps.launches` counts kernel launches."""
    out = _run(hp_all, oy, ox, gate, m, K, 1, 1, window_accumulate_taps_reference,
               padded=True)
    if hp_all.device.type == "cuda":
        window_accumulate_taps.launches += 1
    return out


def window_accumulate_taps_backward(hp_all, oy, ox, gate, ct, m: int, K: int):
    """VJP of `window_accumulate_taps`: ct [B, Ho, Wo, Cout] fp32, contiguous
    -> (d hp_all over the whole padded map in hp_all's dtype, d oy, d ox,
    d gate [B, K, Ho, Wo] fp32). `.launches` counts kernel launches."""
    out = _run_backward(hp_all, oy, ox, gate, ct, m, K, 1, 1,
                        window_accumulate_taps_backward_reference, padded=True)
    if hp_all.device.type == "cuda":
        window_accumulate_taps_backward.launches += 1
    return out


def _single(hp, oy, ox):
    """Row 4's arguments as the padded taps sum takes them: fp32 only, and
    offsets [B, Ho, Wo] as [B, 1, Ho, Wo]."""
    if hp.dtype != torch.float32:
        raise TypeError(f"window_accumulate takes a float32 hp, got {hp.dtype}")
    if oy.dim() != 3 or ox.dim() != 3:
        raise ValueError(f"oy/ox must be [B, Ho, Wo]; got {tuple(oy.shape)}, "
                         f"{tuple(ox.shape)}")
    return oy.unsqueeze(1), ox.unsqueeze(1)


def window_accumulate(hp, oy, ox, m: int) -> torch.Tensor:
    """Single-map window sum, no gate: hp [B, Ho+2m+1, Wo+2m+1, C] fp32,
    contiguous; oy/ox [B, Ho, Wo] fp32 clamped to [-m, m]; -> [B, Ho, Wo, C]
    fp32. `window_accumulate.launches` counts kernel launches."""
    oy4, ox4 = _single(hp, oy, ox)
    out = _run(hp, oy4, ox4, None, m, 1, 1, 1, window_accumulate_taps_reference, padded=True)
    if hp.device.type == "cuda":
        window_accumulate.launches += 1
    return out


def window_accumulate_backward(hp, oy, ox, ct, m: int):
    """VJP of `window_accumulate`: ct [B, Ho, Wo, C] fp32, contiguous ->
    (d hp over the whole padded map, d oy, d ox [B, Ho, Wo]), fp32.
    `.launches` counts kernel launches."""
    oy4, ox4 = _single(hp, oy, ox)
    dhp, doy, dox, _ = _run_backward(hp, oy4, ox4, None, ct, m, 1, 1, 1,
                                     window_accumulate_taps_backward_reference, padded=True)
    if hp.device.type == "cuda":
        window_accumulate_backward.launches += 1
    return dhp, doy.squeeze(1), dox.squeeze(1)


class _WindowTapsPadded(torch.autograd.Function):
    """`window_accumulate_taps` and its VJP through the wrappers."""

    @staticmethod
    def forward(ctx, hp_all, oy, ox, gate, m, K):
        ctx.save_for_backward(hp_all, oy, ox, gate)
        ctx.taps = (m, K)
        return window_accumulate_taps(hp_all, oy, ox, gate, m, K)

    @staticmethod
    def backward(ctx, ct):
        grads = window_accumulate_taps_backward(*ctx.saved_tensors, ct.contiguous(), *ctx.taps)
        return (*grads, None, None)


class _WindowSingle(torch.autograd.Function):
    """`window_accumulate` and its VJP through the wrappers."""

    @staticmethod
    def forward(ctx, hp, oy, ox, m):
        ctx.save_for_backward(hp, oy, ox)
        ctx.m = m
        return window_accumulate(hp, oy, ox, m)

    @staticmethod
    def backward(ctx, ct):
        return (*window_accumulate_backward(*ctx.saved_tensors, ct.contiguous(), ctx.m), None)


def window_taps_padded(hp_all, oy, ox, gate, m: int, K: int) -> torch.Tensor:
    """Differentiable `window_accumulate_taps`, with gradients for hp_all,
    oy, ox and gate."""
    return _WindowTapsPadded.apply(hp_all, oy, ox, gate, m, K)


def window_single(hp, oy, ox, m: int) -> torch.Tensor:
    """Differentiable `window_accumulate`, with gradients for hp, oy and ox."""
    return _WindowSingle.apply(hp, oy, ox, m)


window_accumulate_taps_inpad.launches = 0
window_accumulate_taps_s2.launches = 0
window_accumulate_taps_inpad_backward.launches = 0
window_accumulate_taps_s2_backward.launches = 0
window_accumulate_taps.launches = 0
window_accumulate_taps_backward.launches = 0
window_accumulate.launches = 0
window_accumulate_backward.launches = 0
KERNELS = (window_accumulate_taps_inpad, window_accumulate_taps_s2,
           window_accumulate_taps_inpad_backward, window_accumulate_taps_s2_backward,
           window_accumulate_taps, window_accumulate_taps_backward,
           window_accumulate, window_accumulate_backward)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
