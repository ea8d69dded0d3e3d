"""ROIAlign and ROIPool on NHWC maps (counterpart of
`lpi_tpu/ops/roi_align.py`), per-ROI bilinear grids on
`ops/bilinear.py:bilinear_sample`.

ROIs are [R, 5] (batch index, x1, y1, x2, y2) in input coordinates; a row
whose batch index is below 0 gives zeros. The aligned=False convention (no
half-pixel shift): each of the out x out bins takes `sampling_ratio` x
`sampling_ratio` bilinear taps, averaged ("avg") or maxed ("max"); an ROI's
sides are at least 1 after `spatial_scale`. Differentiable in the features.
"""

from __future__ import annotations

import torch

from lpi_tpu_torch.ops.bilinear import bilinear_sample


def _axis(lo: torch.Tensor, size: torch.Tensor, out_size: int, s: int) -> torch.Tensor:
    """[R] start and side -> [R, out * s] tap coordinates along one axis."""
    bins = (size / out_size)[:, None, None]
    i = torch.arange(out_size, dtype=lo.dtype, device=lo.device)[:, None]
    j = torch.arange(s, dtype=lo.dtype, device=lo.device)[None, :]
    taps = i * bins + (j + 0.5) * bins / s + lo[:, None, None]
    return taps.reshape(lo.shape[0], out_size * s)


def roi_align(features: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
              spatial_scale: float = 1.0, sampling_ratio: int = 2,
              mode: str = "avg") -> torch.Tensor:
    """features [B, H, W, C], rois [R, 5] -> [R, out_size, out_size, C], fp32."""
    B = features.shape[0]
    s = sampling_ratio
    R = rois.shape[0]
    bidx = rois[:, 0].long()
    x1, y1, x2, y2 = (rois[:, i] * spatial_scale for i in range(1, 5))
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    n = out_size * s
    yy = _axis(y1, rh, out_size, s)[:, :, None].expand(R, n, n)
    xx = _axis(x1, rw, out_size, s)[:, None, :].expand(R, n, n)
    vals = bilinear_sample(features.float(), yy, xx, batch=torch.clamp(bidx, 0, B - 1))
    vals = vals.reshape(R, out_size, s, out_size, s, -1)
    pooled = vals.mean(dim=(2, 4)) if mode == "avg" else vals.amax(dim=(2, 4))
    return torch.where((bidx >= 0)[:, None, None, None], pooled, torch.zeros_like(pooled))


def roi_pool(features: torch.Tensor, rois: torch.Tensor, out_size: int = 7,
             spatial_scale: float = 1.0) -> torch.Tensor:
    """Max ROI pooling, approximated by the max over a dense 4 x 4 tap grid
    per bin."""
    return roi_align(features, rois, out_size, spatial_scale, sampling_ratio=4, mode="max")
