"""Layers with Flax's dtype rules, NHWC at the edges.

Parameters are stored in fp32. A layer built with `compute_dtype` casts its
input and parameters to that type (Flax `dtype=`); one built without it
computes in the promotion of the input's and the parameters' types, so a
bf16 input meets fp32 weights in fp32 (Flax's `dtype=None`). Norms compute
in fp32 and return fp32; callers cast, as the JAX modules do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _compute_dtype(x: torch.Tensor, param: torch.Tensor,
                   dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, param.dtype)


class Dense(nn.Linear):
    """`flax.linen.Dense`: y = x @ W.T + b with Flax's dtype rule."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = _compute_dtype(x, self.weight, self.compute_dtype)
        b = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), b)


def same_padding(size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF/Flax 'SAME' padding (low, high) for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """`flax.linen.Conv` with 'SAME' padding on NHWC tensors (weights OIHW).

    Stride-2 'SAME' pads asymmetrically on even inputs (0 before, 1 after),
    which torch's symmetric `padding=` cannot express, so the pad is
    explicit."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=0, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = _compute_dtype(x, self.weight, self.compute_dtype)
        _, H, W, _ = x.shape
        k, s = self.kernel_size[0], self.stride[0]
        ph, pw = same_padding(H, k, s), same_padding(W, k, s)
        xc = x.to(cd).permute(0, 3, 1, 2)
        if any(ph + pw):
            xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
        b = None if self.bias is None else self.bias.to(cd)
        y = F.conv2d(xc, self.weight.to(cd), b, stride=s)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed and returned in fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over NHWC tensors, computed and returned in fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups,
                         self.weight, self.bias, self.eps)
        return y.permute(0, 2, 3, 1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor]) -> torch.Tensor:
    """`jax.nn.dot_product_attention` (XLA form) on [B, S, heads, D]: fp32
    logits scaled by 1/sqrt(D), additive fp32 bias, fp32 softmax, then the
    probabilities in the value's type times the values."""
    dt = v.dtype
    qh = q.float().transpose(1, 2)
    kh = k.float().transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if bias is not None:
        logits = logits + bias
    probs = logits.softmax(-1).to(dt)
    return torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2)
