"""Deformable 3x3 convs, NHWC, by three routes (counterparts of
`lpi_tpu/ops/deform_conv.py:deform_conv2d_pallas`, `deform_conv2d_fused`
and `deform_conv2d`). The window form keeps the name `deform_conv2d`; the
JAX package's `deform_conv2d`, the gather form, is `deform_conv2d_exact`
here.

* `deform_conv2d`, matmul first (`deform_impl` "pallas", "fast",
  "fast_scan"): sampling is linear, so each tap's matmul commutes with it,
  `sample(feat) @ W_k == sample(feat @ W_k)`. One fp32 matmul
  `feats [B*H*W, C] @ W [C, K*Cout]` gives the tap-major product map; the
  gated hat-window sum over it runs in one kernel call
  (`ops/deform_window_kernel.py:window_taps`). Unlike the JAX package,
  every Cout takes the kernel: the TPU's 128-lane rule does not carry over.
* `deform_conv2d_fused`, sample first (`deform_impl="fused"`): each tap's
  bilinear samples and their product with W_k run in one kernel
  (`ops/fused_deform_kernel.py:fused_taps`), fp32 throughout, stride 2
  native.

* `deform_conv2d_exact`, the gather form (`deform_impl="exact"`): one tap
  at a time, a bilinear gather (`ops/bilinear.py`) of the fp32 features at
  the shifted points into a [B, Ho, Wo, C] map, gated, then a [C, Cout]
  product, accumulated in fp32. Offsets are not clamped and the border
  follows ROIAlign's convention, so it differs from the other two at the
  border by design. The JAX package computes it outside any Pallas kernel:
  plain torch ops here, no CUDA kernel.

The first two are `torch.autograd.Function`s whose backward is a kernel
too. Their offsets are clamped to +-max_offset and borders are
zero-padded, exactly as in the JAX package; the clamp is written as
`ops/clip.py:clip`, whose gradient at exactly +-max_offset is 0.5 as
`jnp.clip`'s is (`Tensor.clamp` passes 1 there).
"""

from __future__ import annotations

import torch

from lpi_tpu_torch.ops.bilinear import bilinear_sample
from lpi_tpu_torch.ops.clip import clip
from lpi_tpu_torch.ops.deform_window_kernel import window_taps
from lpi_tpu_torch.ops.fused_deform_kernel import fused_taps


def _offsets_and_gate(features, offsets, mask, stride, K, m):
    """Clamped offsets and the sigmoid gate as [B, K, Ho, Wo] fp32 maps."""
    B, H, W, _ = features.shape
    Ho = (H + stride - 1) // stride
    Wo = (W + stride - 1) // stride
    off = clip(offsets.reshape(B, Ho, Wo, K, 2).float(), -m, m)
    gate = (torch.sigmoid(mask.float()) if mask is not None
            else torch.ones((B, Ho, Wo, K), dtype=torch.float32,
                            device=features.device))
    oy = off[..., 0].permute(0, 3, 1, 2).contiguous()
    ox = off[..., 1].permute(0, 3, 1, 2).contiguous()
    return oy, ox, gate.permute(0, 3, 1, 2).contiguous()


def deform_conv2d(
    features: torch.Tensor,  # [B, H, W, C]
    offsets: torch.Tensor,  # [B, Ho, Wo, 2*K] (dy, dx interleaved per tap)
    weights: torch.Tensor,  # [kh, kw, C, Cout]
    bias: torch.Tensor | None = None,  # [Cout]
    mask: torch.Tensor | None = None,  # [B, Ho, Wo, K] pre-sigmoid (DCNv2)
    stride: int = 1,
    max_offset: int = 3,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Deformable 3x3 conv, 'same' padding, stride 1 or 2; output in the
    features' dtype. `compute_dtype` is the product map's storage type
    (fp32 or bf16); the window sum accumulates in fp32 either way."""
    if stride not in (1, 2):
        raise ValueError(f"deform_conv2d supports stride 1 and 2, got {stride}")
    C = features.shape[-1]
    kh, kw, _, Cout = weights.shape
    K = kh * kw
    m = max_offset
    oy, ox, gk = _offsets_and_gate(features, offsets, mask, stride, K, m)
    w_all = weights.float().reshape(K, C, Cout).permute(1, 0, 2).reshape(C, K * Cout)
    h_all = torch.matmul(features.float(), w_all).to(compute_dtype)
    out = window_taps(h_all.contiguous(), oy, ox, gk, m, K, kw, stride)
    if bias is not None:
        out = out + bias.float()
    return out.to(features.dtype)


def deform_conv2d_fused(
    features: torch.Tensor,  # [B, H, W, C]
    offsets: torch.Tensor,  # [B, Ho, Wo, 2*K]
    weights: torch.Tensor,  # [kh, kw, C, Cout]
    bias: torch.Tensor | None = None,  # [Cout]
    mask: torch.Tensor | None = None,  # [B, Ho, Wo, K] pre-sigmoid
    stride: int = 1,
    max_offset: int = 3,
) -> torch.Tensor:
    """Sample-first deformable 3x3 conv, 'same' padding, stride 1 or 2,
    fp32 inside; output in the features' dtype. Stride 2 samples at
    2y + ky - 1 + d directly: the JAX package's offset upsample, stride-1
    run and subsample give the same function and gradients (the dropped
    positions carry a zero cotangent) at four times the work."""
    if stride not in (1, 2):
        raise ValueError(f"deform_conv2d_fused supports stride 1 and 2, got {stride}")
    C = features.shape[-1]
    kh, kw, _, Cout = weights.shape
    K = kh * kw
    m = max_offset
    oy, ox, gk = _offsets_and_gate(features, offsets, mask, stride, K, m)
    w = weights.float().reshape(K, C, Cout).contiguous()
    out = fused_taps(features.float().contiguous(), oy, ox, gk, w, m, kw, stride)
    if bias is not None:
        out = out + bias.float()
    return out.to(features.dtype)


def deform_conv2d_exact(
    features: torch.Tensor,  # [B, H, W, C]
    offsets: torch.Tensor,  # [B, Ho, Wo, 2*K] (dy, dx interleaved per tap)
    weights: torch.Tensor,  # [kh, kw, C, Cout]
    bias: torch.Tensor | None = None,  # [Cout]
    mask: torch.Tensor | None = None,  # [B, Ho, Wo, K] pre-sigmoid (DCNv2)
    stride: int = 1,
) -> torch.Tensor:
    """Gather-form deformable conv, 'same' padding, any stride, fp32 inside;
    output in the features' dtype. Tap k samples at (y * stride + ky - 1 +
    dy_k, x * stride + kx - 1 + dx_k)."""
    B, H, W, C = features.shape
    kh, kw, _, Cout = weights.shape
    K = kh * kw
    Ho = (H + stride - 1) // stride
    Wo = (W + stride - 1) // stride
    dev = features.device
    base_y = (torch.arange(Ho, device=dev) * stride).float()
    base_x = (torch.arange(Wo, device=dev) * stride).float()
    off = offsets.reshape(B, Ho, Wo, K, 2).float()
    gate = torch.sigmoid(mask.float()) if mask is not None else None
    w = weights.float().reshape(K, C, Cout)
    feats32 = features.float()
    out = torch.zeros((B, Ho, Wo, Cout), dtype=torch.float32, device=dev)
    for k in range(K):
        ky, kx = k // kw - (kh - 1) // 2, k % kw - (kw - 1) // 2
        sy = (base_y[:, None] + ky) + off[..., k, 0]  # [B, Ho, Wo]
        sx = (base_x[None, :] + kx) + off[..., k, 1]
        sampled = bilinear_sample(feats32, sy, sx)  # [B, Ho, Wo, C]
        if gate is not None:
            sampled = sampled * gate[..., k, None]
        out = out + torch.matmul(sampled, w[k])
    if bias is not None:
        out = out + bias.float()
    return out.to(features.dtype)
