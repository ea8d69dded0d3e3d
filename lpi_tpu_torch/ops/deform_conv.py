"""Matmul-first windowed deformable conv, NHWC (counterpart of
`lpi_tpu/ops/deform_conv.py:deform_conv2d_pallas`).

Sampling is linear, so each tap's matmul commutes with it:
`sample(feat) @ W_k == sample(feat @ W_k)`. One fp32 matmul
`feats [B*H*W, C] @ W [C, K*Cout]` gives the tap-major product map; the
gated hat-window sum over it runs in one kernel call
(`ops/deform_window_kernel.py`). Offsets are clamped to +-max_offset and
borders are zero-padded, exactly as in the JAX package. Unlike there, every
Cout takes the kernel: the TPU's 128-lane rule does not carry over.
"""

from __future__ import annotations

import torch

from lpi_tpu_torch.ops.deform_window_kernel import (
    window_accumulate_taps_inpad, window_accumulate_taps_s2)


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
    B, H, W, C = features.shape
    kh, kw, _, Cout = weights.shape
    K = kh * kw
    m = max_offset
    Ho = (H + stride - 1) // stride
    Wo = (W + stride - 1) // stride
    off = offsets.reshape(B, Ho, Wo, K, 2).float().clamp(-m, m)
    gate = (torch.sigmoid(mask.float()) if mask is not None
            else torch.ones((B, Ho, Wo, K), dtype=torch.float32,
                            device=features.device))
    w_all = weights.float().reshape(K, C, Cout).permute(1, 0, 2).reshape(C, K * Cout)
    h_all = torch.matmul(features.float(), w_all).to(compute_dtype)
    oy = off[..., 0].permute(0, 3, 1, 2).contiguous()  # [B, K, Ho, Wo]
    ox = off[..., 1].permute(0, 3, 1, 2).contiguous()
    gk = gate.permute(0, 3, 1, 2).contiguous()
    accumulate = (window_accumulate_taps_inpad if stride == 1
                  else window_accumulate_taps_s2)
    out = accumulate(h_all.contiguous(), oy, ox, gk, m, K, kw)
    if bias is not None:
        out = out + bias.float()
    return out.to(features.dtype)
