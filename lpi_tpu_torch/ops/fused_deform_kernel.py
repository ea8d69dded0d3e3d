"""Sample-first fused deformable conv: CUDA kernels and their plain versions.

The fused route samples first and multiplies after, per tap k:

    samp_k[b,y,x,c] = sum_{dy,dx in [-m, m+1]} g_k hat(oy_k, dy) hat(ox_k, dx)
                      * f[b, S*y + ky - 1 + dy, S*x + kx - 1 + dx, c]
    out[b,y,x,n]    = sum_k sum_c samp_k[b,y,x,c] W[k,c,n]

with hat(o, d) = max(0, 1 - |o - d|), stride S (1 or 2), zero outside the
map, fp32 throughout. Two wrappers, each with its own launch counter:

* `fused_deform`: the forward, replacing the Pallas TPU kernel
  `lpi_tpu/ops/fused_deform_kernel.py:fused_deform` (`_fused_fwd_kernel`);
* `fused_deform_backward`: its VJP (`_fused_vjp_bwd`, `_fused_bwd_kernel`),
  giving d f, d oy, d ox, d gate and, when asked, d W.

Unlike the JAX package they take the UNPADDED features [B, H, W, C] and
read the zero border by bounds checks, so there is no pad pass and no pad
VJP; stride 2 is native (the JAX package upsamples the offsets, runs at
stride 1 and subsamples). `fused_taps` is the differentiable entry: a
`torch.autograd.Function` that computes d W only when W needs a gradient.

The kernels live in `lpi_tpu_torch/csrc/fused_deform.cu` (design and bound
in its header note). A wrapper takes its plain version only for tensors on
the CPU; for CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from lpi_tpu_torch.ops import cuda_build
from lpi_tpu_torch.ops.deform_window_kernel import _dhat, _hat


# --------------------------------------------------------------------------
# plain versions: the loops of the JAX oracle and of the Pallas VJP
# --------------------------------------------------------------------------

def _padded(feats, m):
    """Zero-pad (m+1, m+2) on both spatial axes, as the JAX package does:
    window start (ky + dy + m) then reads f[. + ky - 1 + dy]."""
    return F.pad(feats, (0, 0, m + 1, m + 2, m + 1, m + 2))


def _window(k, dy, dx, m, kw, Ho, Wo, stride):
    r0, c0 = k // kw + dy + m, k % kw + dx + m
    return (slice(r0, r0 + stride * (Ho - 1) + 1, stride),
            slice(c0, c0 + stride * (Wo - 1) + 1, stride))


def _sample_tap(fp, oy, ox, gate, k, m, kw, stride):
    """samp_k [B, Ho, Wo, C] fp32 from the padded features."""
    B, _, _, C = fp.shape
    Ho, Wo = oy.shape[2], oy.shape[3]
    samp = torch.zeros((B, Ho, Wo, C), dtype=torch.float32, device=fp.device)
    wxs = [_hat(ox[:, k], dx) for dx in range(-m, m + 2)]
    for dy in range(-m, m + 2):
        gwy = gate[:, k] * _hat(oy[:, k], dy)  # the same products, formed once a row
        for dx, wx in zip(range(-m, m + 2), wxs):
            rows, cols = _window(k, dy, dx, m, kw, Ho, Wo, stride)
            samp = samp + (gwy * wx)[..., None] * fp[:, rows, cols]
    return samp


def fused_deform_reference(feats, oy, ox, gate, w, m: int, kw: int = 3, stride: int = 1):
    """Plain forward (`fused_deform_reference` of the JAX package, on the
    unpadded map, at stride 1 or 2): feats [B, H, W, C]; oy/ox/gate
    [B, K, Ho, Wo]; w [K, C, Cout]; -> [B, Ho, Wo, Cout] fp32."""
    fp = _padded(feats.float(), m)
    B, Ho, Wo = oy.shape[0], oy.shape[2], oy.shape[3]
    K, _, Cout = w.shape
    out = torch.zeros((B, Ho, Wo, Cout), dtype=torch.float32, device=feats.device)
    for k in range(K):
        out = out + torch.matmul(_sample_tap(fp, oy, ox, gate, k, m, kw, stride), w[k])
    return out


def fused_deform_backward_reference(feats, oy, ox, gate, w, ct, m: int, kw: int = 3,
                                    stride: int = 1, need_dw: bool = True):
    """Plain VJP, written out as the Pallas backward computes it: per tap
    u_k = ct @ W_k^T; every displacement scatters g * hat * hat * u_k into
    d f and adds its channel sums s = sum_c u_k * window to d oy, d ox,
    d gate with the Pallas `_dhat` (0 at integer offsets, where autograd of
    the hat would not be); d W_k = samp_k^T @ ct. -> (d feats, d oy, d ox,
    d gate, d W or None), fp32."""
    fp = _padded(feats.float(), m)
    B, H, W, C = feats.shape
    Ho, Wo = oy.shape[2], oy.shape[3]
    K = w.shape[0]
    dfp = torch.zeros_like(fp)
    doy, dox, dg = (torch.zeros((B, K, Ho, Wo), dtype=torch.float32, device=feats.device)
                    for _ in range(3))
    dw = torch.zeros_like(w) if need_dw else None
    for k in range(K):
        u = torch.matmul(ct, w[k].T)
        if need_dw:
            samp = _sample_tap(fp, oy, ox, gate, k, m, kw, stride)
            dw[k] = torch.matmul(samp.reshape(-1, C).T, ct.reshape(-1, ct.shape[-1]))
        g = gate[:, k]
        xs = [(dx, _hat(ox[:, k], dx), _dhat(ox[:, k], dx)) for dx in range(-m, m + 2)]
        for dy in range(-m, m + 2):
            wy, gy = _hat(oy[:, k], dy), _dhat(oy[:, k], dy)
            ggy, gwy = g * gy, g * wy  # the same products, formed once a row
            for dx, wx, gx in xs:
                rows, cols = _window(k, dy, dx, m, kw, Ho, Wo, stride)
                s = (u * fp[:, rows, cols]).sum(-1)
                doy[:, k] += ggy * wx * s
                dox[:, k] += gwy * gx * s
                dg[:, k] += wy * wx * s
                dfp[:, rows, cols] += (gwy * wx)[..., None] * u
    return dfp[:, m + 1:m + 1 + H, m + 1:m + 1 + W], doy, dox, dg, dw


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _check(feats, oy, ox, gate, w, m, kw, stride):
    if feats.dim() != 4 or oy.dim() != 4 or w.dim() != 3:
        raise ValueError(f"feats must be [B,H,W,C], offsets [B,K,Ho,Wo] and w [K,C,Cout]; "
                         f"got {tuple(feats.shape)}, {tuple(oy.shape)}, {tuple(w.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"the fused deform conv supports stride 1 and 2, got {stride}")
    B, H, W, C = feats.shape
    K, Cw, Cout = w.shape
    if K <= 0 or kw <= 0 or K % kw or Cw != C or Cout == 0 or m < 0:
        raise ValueError(f"bad taps: K={K}, kw={kw}, m={m}, C={C}, w {tuple(w.shape)}")
    Ho, Wo = (H + stride - 1) // stride, (W + stride - 1) // stride
    want = (B, K, Ho, Wo)
    for name, t in (("feats", feats), ("oy", oy), ("ox", ox), ("gate", gate), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != feats.device:
            raise ValueError(f"{name} is on {t.device}, feats on {feats.device}")
        if name in ("oy", "ox", "gate") and tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want}")
    if B * H * W * C == 0:
        raise ValueError("empty feature map")
    return B, H, W, C, K, Cout, Ho, Wo


def _check_ct(ct, B, Ho, Wo, Cout, device):
    if tuple(ct.shape) != (B, Ho, Wo, Cout):
        raise ValueError(f"ct has shape {tuple(ct.shape)}, want {(B, Ho, Wo, Cout)}")
    if ct.dtype != torch.float32:
        raise TypeError(f"ct must be float32, got {ct.dtype}")
    if ct.device != device:
        raise ValueError(f"ct is on {ct.device}, feats on {device}")


def _contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _fwd_entry():
    """The kernel library's C entry points, built and typed at first use."""
    fn = cuda_build.load("fused_deform").lpi_fused_deform_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_entry():
    fn = cuda_build.load("fused_deform").lpi_fused_deform_bwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _splits_entry():
    fn = cuda_build.load("fused_deform").lpi_fused_deform_dw_splits
    fn.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn


def _dw_splits(npix: int, K: int, C: int, Cout: int) -> int:
    """Pixel ranges of the d W pass, which size its partial tiles: the
    kernel source's own rule, from its own tile (`lpi_fused_deform_dw_splits`)."""
    return _splits_entry()(npix, K, C, Cout)


def _launch(feats, oy, ox, gate, w, m, kw, stride):
    B, H, W, C, K, Cout, Ho, Wo = _check(feats, oy, ox, gate, w, m, kw, stride)
    _contiguous(feats=feats, oy=oy, ox=ox, gate=gate, w=w)
    out = torch.empty((B, Ho, Wo, Cout), dtype=torch.float32, device=feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fwd_entry()(feats.data_ptr(), oy.data_ptr(), ox.data_ptr(), gate.data_ptr(),
                           w.data_ptr(), out.data_ptr(), B, H, W, C, Ho, Wo, K, kw, Cout, m,
                           stride, stream)
    if err != 0:
        raise RuntimeError(f"fused deform kernel (stride {stride}) failed to launch: "
                           f"CUDA error {err}")
    return out


def _launch_backward(feats, oy, ox, gate, w, ct, m, kw, stride, need_dw):
    B, H, W, C, K, Cout, Ho, Wo = _check(feats, oy, ox, gate, w, m, kw, stride)
    _check_ct(ct, B, Ho, Wo, Cout, feats.device)
    _contiguous(feats=feats, oy=oy, ox=ox, gate=gate, w=w, ct=ct)
    dev = feats.device
    npix = B * Ho * Wo
    u = torch.empty((npix, K * C), dtype=torch.float32, device=dev)
    df = torch.empty_like(feats)
    doy, dox, dg = (torch.empty_like(oy) for _ in range(3))
    dw = partial = None
    splits = 1
    if need_dw:
        splits = _dw_splits(npix, K, C, Cout)
        dw = torch.empty_like(w)
        partial = torch.empty((splits, K, C, Cout), dtype=torch.float32, device=dev)
    vec = 4 if C % 4 == 0 and feats.data_ptr() % 16 == 0 else 1
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_entry()(
            feats.data_ptr(), oy.data_ptr(), ox.data_ptr(), gate.data_ptr(), w.data_ptr(),
            ct.data_ptr(), u.data_ptr(), df.data_ptr(), doy.data_ptr(), dox.data_ptr(),
            dg.data_ptr(), None if partial is None else partial.data_ptr(),
            None if dw is None else dw.data_ptr(), B, H, W, C, Ho, Wo, K, kw, Cout, m, stride,
            splits, vec, stream)
    if err != 0:
        raise RuntimeError(f"fused deform backward kernels (stride {stride}) failed to "
                           f"launch: CUDA error {err}")
    return df, doy, dox, dg, dw


def fused_deform(feats, oy, ox, gate, w, m: int, kw: int = 3, stride: int = 1) -> torch.Tensor:
    """Fused deformable conv core, stride 1 or 2.

    feats [B, H, W, C], oy/ox/gate [B, K, Ho, Wo] (offsets clamped to
    [-m, m]), w [K, C, Cout], all fp32 and contiguous; -> [B, Ho, Wo, Cout]
    fp32. `fused_deform.launches` counts kernel launches.
    """
    if feats.device.type == "cpu":
        _check(feats, oy, ox, gate, w, m, kw, stride)
        return fused_deform_reference(feats, oy, ox, gate, w, m, kw, stride)
    if feats.device.type != "cuda":
        raise ValueError(f"no fused deform kernel for device {feats.device}")
    out = _launch(feats, oy, ox, gate, w, m, kw, stride)
    fused_deform.launches += 1
    return out


def fused_deform_backward(feats, oy, ox, gate, w, ct, m: int, kw: int = 3, stride: int = 1,
                          need_dw: bool = True):
    """VJP of `fused_deform`: ct [B, Ho, Wo, Cout] fp32, contiguous ->
    (d feats, d oy, d ox, d gate, d W or None when not `need_dw`), fp32.
    One call is up to four kernel launches, counted once in
    `fused_deform_backward.launches`; `.dw_launches` counts the calls that
    computed d W."""
    if feats.device.type == "cpu":
        B, _, _, _, _, Cout, Ho, Wo = _check(feats, oy, ox, gate, w, m, kw, stride)
        _check_ct(ct, B, Ho, Wo, Cout, feats.device)
        return fused_deform_backward_reference(feats, oy, ox, gate, w, ct, m, kw, stride,
                                               need_dw)
    if feats.device.type != "cuda":
        raise ValueError(f"no fused deform kernel for device {feats.device}")
    grads = _launch_backward(feats, oy, ox, gate, w, ct, m, kw, stride, need_dw)
    fused_deform_backward.launches += 1
    fused_deform_backward.dw_launches += int(need_dw)
    return grads


class _FusedTaps(torch.autograd.Function):
    """Forward and backward through the wrappers: the kernels for CUDA
    tensors, the plain versions for CPU tensors. d W is computed only when
    W needs a gradient (the full-parameter pretrain, not the continual step
    with its frozen head)."""

    @staticmethod
    def forward(ctx, feats, oy, ox, gate, w, m, kw, stride):
        ctx.save_for_backward(feats, oy, ox, gate, w)
        ctx.taps = (m, kw, stride)
        return fused_deform(feats, oy, ox, gate, w, m, kw, stride)

    @staticmethod
    def backward(ctx, ct):
        m, kw, stride = ctx.taps
        # autograd may hand over a strided cotangent; the kernels take none
        grads = fused_deform_backward(*ctx.saved_tensors, ct.contiguous(), m, kw, stride,
                                      need_dw=ctx.needs_input_grad[4])
        return (*grads, None, None, None)


def fused_taps(feats, oy, ox, gate, w, m: int, kw: int = 3, stride: int = 1) -> torch.Tensor:
    """Differentiable fused deformable conv core: the arguments and result
    of `fused_deform`, with gradients for feats, oy, ox, gate and w."""
    return _FusedTaps.apply(feats, oy, ox, gate, w, m, kw, stride)


fused_deform.launches = 0
fused_deform_backward.launches = 0
fused_deform_backward.dw_launches = 0
KERNELS = (fused_deform, fused_deform_backward)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    fused_deform_backward.dw_launches = 0
