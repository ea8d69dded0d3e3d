"""Deformable position-sensitive ROI pooling, DCN's DeformRoIPooling
(counterpart of `lpi_tpu/ops/deform_pool.py`).

* ROI corners are rounded (half to even, as `jnp.round`), scaled by
  `spatial_scale` and shifted by -0.5, the far side +1 before scaling;
  sides at least 0.1;
* each bin takes a `sample_per_part` x `sample_per_part` sub-grid; a
  sample outside [-0.5, side - 0.5] is skipped, the others are clamped into
  the map and sampled bilinearly; a bin is the mean of its samples (0
  without any);
* output channel c at bin (ph, pw) reads input channel
  (c * group + gh) * group + gw, (gh, gw) the bin's group cell;
* optional offsets `trans` [N, classes * 2, part, part], times `trans_std`
  and the ROI's side, indexed by the bin's part cell and shared by its
  class's block of output channels.

Only the position-sensitive channels are gathered (JAX samples all C and
then selects; the arithmetic per output value is the same). NHWC features,
rois [N, 5] = (batch index, x1, y1, x2, y2). Differentiable in the
features and the offsets.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lpi_tpu_torch.ops.bilinear import bilinear_sample
from lpi_tpu_torch.ops.clip import clip


def deform_psroi_pool(features: torch.Tensor, rois: torch.Tensor,
                      trans: Optional[torch.Tensor] = None, out_size: int = 7,
                      out_dim: Optional[int] = None, spatial_scale: float = 1.0,
                      sample_per_part: int = 4, group_size: int = 1,
                      part_size: Optional[int] = None,
                      trans_std: float = 0.1) -> torch.Tensor:
    """features [B, H, W, C] (C = out_dim * group_size^2), rois [N, 5],
    trans [N, classes * 2, part, part] or None -> [N, out, out, out_dim]."""
    B, H, W, C = features.shape
    g = group_size
    out_dim = out_dim or C // (g * g)
    part = part_size or out_size
    num_classes = 1 if trans is None else trans.shape[1] // 2
    ch_each = out_dim // num_classes
    dev = features.device

    idx = np.arange(out_size)
    gcell = np.clip((idx * g) // out_size, 0, g - 1)
    part_cell = torch.from_numpy(np.minimum((idx * part) // out_size, part - 1)).to(dev)
    ct = np.arange(out_dim)
    cmap = torch.from_numpy((ct[None, None, :] * g + gcell[:, None, None]) * g
                            + gcell[None, :, None]).to(dev)  # [out, out, out_dim]

    N = rois.shape[0]
    col = lambda v: v[:, None, None]  # noqa: E731  [N] -> [N, 1, 1]
    b = rois[:, 0].long()
    x1 = col(torch.round(rois[:, 1]) * spatial_scale - 0.5)
    y1 = col(torch.round(rois[:, 2]) * spatial_scale - 0.5)
    x2 = col((torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5)
    y2 = col((torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5)
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    bin_w = rw / out_size
    bin_h = rh / out_size
    sub_w = bin_w / sample_per_part
    sub_h = bin_h / sample_per_part
    pos = torch.arange(out_size, dtype=features.dtype, device=dev)
    wstart = pos[None, None, :] * bin_w + x1  # [N, 1, out]
    hstart = pos[None, :, None] * bin_h + y1  # [N, out, 1]

    chunks = []
    for cls in range(num_classes):
        if trans is not None:
            tcls = trans.reshape(N, num_classes, 2, part, part)[:, cls] * trans_std
            offx = tcls[:, 0][:, part_cell][:, :, part_cell] * rw  # [N, out, out]
            offy = tcls[:, 1][:, part_cell][:, :, part_cell] * rh
        else:
            offx = offy = 0.0
        channels = cmap[..., cls * ch_each:(cls + 1) * ch_each]
        total = 0.0
        count = 0.0
        for ih in range(sample_per_part):
            for iw in range(sample_per_part):
                x, y = torch.broadcast_tensors(wstart + offx + iw * sub_w,
                                               hstart + offy + ih * sub_h)
                inside = ((x >= -0.5) & (x <= W - 0.5) & (y >= -0.5) & (y <= H - 0.5))[..., None]
                val = bilinear_sample(features, clip(y, 0.0, H - 1.0), clip(x, 0.0, W - 1.0),
                                      batch=b, channels=channels)
                total = total + torch.where(inside, val, torch.zeros_like(val))
                count = count + inside.float()
        mean = torch.where(count > 0, total / torch.clamp(count, min=1.0),
                           torch.zeros_like(total))
        chunks.append(mean)
    return torch.cat(chunks, dim=-1)
