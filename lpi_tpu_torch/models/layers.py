"""Layers with Flax's dtype rules, NHWC at the edges.

Parameters are stored in fp32. A layer built with `compute_dtype` casts its
input and parameters to that type (Flax `dtype=`); one built without it
computes in the promotion of the input's and the parameters' types, so a
bf16 input meets fp32 weights in fp32 (Flax's `dtype=None`). Norms compute
in fp32 and return fp32; callers cast, as the JAX modules do.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


_CUT = 0.5 * (1.0 + math.erf(-math.sqrt(2.0)))  # P(N(0, 1) < -2)


def normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill `p` with N(0, std^2) draws from `generator` (Flax `normal`)."""
    p.copy_(torch.randn(p.shape, generator=generator) * std)


def uniform_(p: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    """Fill `p` with U(-bound, bound) draws from `generator`."""
    p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)


def xavier_uniform_(p: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's `xavier_uniform` for a Linear weight [out, in]."""
    uniform_(p, math.sqrt(6.0 / (p.shape[0] + p.shape[1])), generator)


def truncated_normal_(p: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """Fill `p` with std times a standard normal cut at +-2, by the inverse
    CDF (Flax `truncated_normal`)."""
    u = _CUT + (1.0 - 2.0 * _CUT) * torch.rand(p.shape, generator=generator,
                                                dtype=torch.float64)
    p.copy_(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0) * std)


def lecun_normal_(p: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's default kernel init for a weight laid out [out, in, ...]:
    variance 1/fan_in, the cut at +-2 undone by the 0.8796 rescale."""
    truncated_normal_(p, 1.0 / math.sqrt(math.prod(p.shape[1:])) / 0.87962566103423978,
                      generator)


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
    explicit. `padding=p` pads p on every side instead (Flax's
    `padding=[(p, p)] * 2`); `groups` is Flax's `feature_group_count`."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None, groups: int = 1,
                 padding: Optional[int] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=0, bias=bias, groups=groups)
        self.compute_dtype = compute_dtype
        self.explicit_padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = _compute_dtype(x, self.weight, self.compute_dtype)
        _, H, W, _ = x.shape
        k, s = self.kernel_size[0], self.stride[0]
        if self.explicit_padding is None:
            ph, pw = same_padding(H, k, s), same_padding(W, k, s)
        else:
            ph = pw = (self.explicit_padding,) * 2
        xc = x.to(cd).permute(0, 3, 1, 2)
        if any(ph + pw):
            xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
        b = None if self.bias is None else self.bias.to(cd)
        y = F.conv2d(xc, self.weight.to(cd), b, stride=s, groups=self.groups)
        return y.permute(0, 2, 3, 1)


def conv_transpose_padding(k: int, s: int) -> Tuple[int, int]:
    """`jax.lax.conv_transpose`'s 'SAME' padding (low, high) of the dilated
    input, for kernel k and stride s."""
    total = k + s - 2
    low = k - 1 if s > k - 1 else -(-total // 2)
    return low, total - low


class ConvTranspose(nn.ConvTranspose2d):
    """`flax.linen.ConvTranspose` with 'SAME' padding on NHWC tensors: the
    input dilated by the stride, padded as `conv_transpose_padding` says and
    correlated with Flax's kernel as it is (`transpose_kernel=False`).
    `F.conv_transpose2d` correlates the dilated input, padded k - 1 - p a
    side, with its weight flipped in space, so the weight here is Flax's
    HWIO kernel flipped in H and W, laid out [in, out, kh, kw]
    (`bridge.py`), and p = k - 1 - low. Output side: input side x stride.
    Only kernels and strides whose 'SAME' padding is even on both sides
    (the zoo's 2x2 and 4x4 at stride 2) are taken."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, bias: bool = True,
                 compute_dtype: Optional[torch.dtype] = None):
        low, high = conv_transpose_padding(kernel_size, stride)
        if low != high:
            raise ValueError(f"ConvTranspose: 'SAME' pads {low} and {high} for kernel "
                             f"{kernel_size}, stride {stride}; only even padding is supported")
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=kernel_size - 1 - low, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = _compute_dtype(x, self.weight, self.compute_dtype)
        b = None if self.bias is None else self.bias.to(cd)
        y = F.conv_transpose2d(x.to(cd).permute(0, 3, 1, 2), self.weight.to(cd), b,
                               stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """`flax.linen.max_pool` with 'SAME' padding (-inf) on NHWC tensors."""
    _, H, W, _ = x.shape
    ph, pw = same_padding(H, k, stride), same_padding(W, k, stride)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(xc, k, stride).permute(0, 2, 3, 1)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed and returned in fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over NHWC tensors, computed and returned in fp32.

    Calls the ATen op directly: `F.group_norm` refuses groups of a single
    value (batch 1, a 1x1 level, one channel per group, as the gate's
    16-channel head has at P6/P7), which Flax normalises to the bias."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups,
                             self.weight, self.bias, self.eps,
                             torch.backends.cudnn.enabled)
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
