"""Bilinear sampling on NHWC feature maps, the gather core of the "exact"
deformable conv, ROIAlign and the deformable PS-ROI pooling (counterpart of
`lpi_tpu/ops/bilinear.py`).

The ROIAlign convention, not the window kernels' hat window: a point at or
beyond -1 or the map's side contributes zero; a point in (-1, 0) (or in
(side - 1, side)) is clamped onto the border row or column, whose value it
takes in full; each corner is clamped into the map. The clamp is
`ops/clip.py:clip`, so the coordinate gradient at a point exactly on a
border is 0.5 of the inside one, as `jnp.clip`'s is. Differentiable with
respect to the features (the gathers' backward is a scatter-add) and the
coordinates.
"""

from __future__ import annotations

from typing import Optional

import torch

from lpi_tpu_torch.ops.clip import clip


def bilinear_sample(features: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
                    batch: Optional[torch.Tensor] = None,
                    channels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample `features` [B, H, W, C] at float coordinates `y`, `x` of shape
    [N, ...]. -> [N, ..., C], zero where the point lies outside
    (-1, H) x (-1, W). Row n of the coordinates reads map n, or map
    `batch[n]` when `batch` [N] (int) is given, without copying the maps.
    `channels` (int, broadcastable to [..., Cs]) reads only those channels
    at each point -> [N, ..., Cs]."""
    B, H, W, C = features.shape
    oob = (y <= -1.0) | (y >= H) | (x <= -1.0) | (x >= W)
    y = clip(y, 0.0, H - 1.0)
    x = clip(x, 0.0, W - 1.0)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    ly = y - y0
    lx = x - x0
    hy = 1.0 - ly
    hx = 1.0 - lx
    flat = features.reshape(B, H * W, C)
    rows = torch.arange(B, device=features.device) if batch is None else batch.long()
    rows = rows.reshape((-1,) + (1,) * (y.dim() - 1))

    def gather(yy, xx):
        lin = yy.long() * W + xx.long()
        if channels is None:
            return flat[rows, lin]
        return flat[rows[..., None], lin[..., None], channels]

    val = (gather(y0, x0) * (hy * hx)[..., None]
           + gather(y0, x1) * (hy * lx)[..., None]
           + gather(y1, x0) * (ly * hx)[..., None]
           + gather(y1, x1) * (ly * lx)[..., None])
    return torch.where(oob[..., None], torch.zeros((), dtype=val.dtype, device=val.device), val)
