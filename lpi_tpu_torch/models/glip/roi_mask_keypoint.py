"""The mask and keypoint ROI heads (counterpart of
`lpi_tpu/models/glip/roi_mask_keypoint.py`):

* `MaskHead`: 4 x (3x3 conv + relu) on the ROI-aligned maps, a 2x2
  stride-2 transposed conv + relu, a 1x1 conv to per-class mask logits at
  twice the pooled side; `mask_loss` is the per-pixel BCE of each ROI's
  matched class channel, `paste_mask_probs` its sigmoid;
* `KeypointHead`: 8 x (3x3 conv + relu), a 4x4 stride-2 'SAME'
  transposed conv, then a bilinear resize to the heatmap side (JAX's
  `jax.image.resize(..., "bilinear")`, which for an upsample is
  `F.interpolate(bilinear, align_corners=False)`); `keypoint_loss` is the
  softmax CE over each visible keypoint's heatmap cell.

The transposed convs are Flax's (`layers.ConvTranspose`): the bridge flips
their kernels. Fixed ROIs a batch; invalid ROIs carry zero weight.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from lpi_tpu_torch.models.layers import Conv, ConvTranspose
from lpi_tpu_torch.ops.clip import clip
from lpi_tpu_torch.ops.roi_align import roi_align


class MaskHead(nn.Module):
    """pooled [R, res, res, C] -> mask logits [R, 2 res, 2 res, classes]."""

    def __init__(self, num_classes: int, channels: int = 256, num_convs: int = 4,
                 resolution: int = 14, dtype: torch.dtype = torch.float32, *,
                 in_channels: Optional[int] = None):
        """`resolution`: the pooled side (the logits come out at twice it);
        `in_channels`: the pooled maps' width, `channels` by default."""
        super().__init__()
        self.resolution = resolution
        in_channels = in_channels or channels
        self.fcn = nn.ModuleList(Conv(in_channels if i == 0 else channels, channels, 3,
                                      compute_dtype=dtype) for i in range(num_convs))
        self.deconv = ConvTranspose(channels, channels, 2, 2, compute_dtype=dtype)
        self.mask_logits = Conv(channels, num_classes, 1)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        h = pooled
        for conv in self.fcn:
            h = F.relu(conv(h))
        return self.mask_logits(F.relu(self.deconv(h)))


def _pick(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """[R, M, M, C] at each ROI's class -> [R, M, M]."""
    R, M, _, _ = logits.shape
    return logits.gather(-1, labels.long().reshape(R, 1, 1, 1).expand(R, M, M, 1))[..., 0]


def mask_loss(mask_logits: torch.Tensor, gt_masks: torch.Tensor, labels: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Per-pixel BCE on each ROI's matched class channel (labels 0-based),
    the mean over the valid ROIs' pixels."""
    sel = _pick(mask_logits, labels).float()
    t = gt_masks.float()
    bce = clip(sel, 0.0) - sel * t + torch.log1p(torch.exp(-sel.abs()))
    w = valid.float()
    return (bce.mean(dim=(1, 2)) * w).sum() / torch.clamp(w.sum(), min=1.0)


def paste_mask_probs(mask_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each ROI's class probability map [R, M, M] (pasting into the image is
    the caller's resize into the ROI box)."""
    return torch.sigmoid(_pick(mask_logits, labels).float())


class KeypointHead(nn.Module):
    """pooled [R, res, res, C] -> heatmap logits [R, S, S, keypoints]."""

    def __init__(self, num_keypoints: int = 17, channels: int = 512, num_convs: int = 8,
                 heatmap_size: int = 56, dtype: torch.dtype = torch.float32, *,
                 in_channels: Optional[int] = None):
        """`in_channels`: the pooled maps' width, `channels` by default."""
        super().__init__()
        in_channels = in_channels or channels
        self.heatmap_size = heatmap_size
        self.conv_fcn = nn.ModuleList(Conv(in_channels if i == 0 else channels, channels, 3,
                                           compute_dtype=dtype) for i in range(num_convs))
        self.kps_score_lowres = ConvTranspose(channels, num_keypoints, 4, 2, compute_dtype=dtype)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        h = pooled
        for conv in self.conv_fcn:
            h = F.relu(conv(h))
        h = self.kps_score_lowres(h).permute(0, 3, 1, 2)
        S = self.heatmap_size
        return F.interpolate(h, size=(S, S), mode="bilinear", align_corners=False,
                             antialias=False).permute(0, 2, 3, 1)


def keypoints_to_heatmap_targets(keypoints: torch.Tensor, rois: torch.Tensor,
                                 heatmap_size: int):
    """keypoints [R, K, 3] (x, y, visibility), rois [R, 4] -> (cell index
    y * S + x [R, K], valid [R, K])."""
    S = heatmap_size
    x1, y1, x2, y2 = (rois[:, i] for i in range(4))
    sx = S / torch.clamp(x2 - x1, min=1e-6)
    sy = S / torch.clamp(y2 - y1, min=1e-6)
    x = ((keypoints[..., 0] - x1[:, None]) * sx[:, None]).int()
    y = ((keypoints[..., 1] - y1[:, None]) * sy[:, None]).int()
    inside = (x >= 0) & (x < S) & (y >= 0) & (y < S)
    valid = inside & (keypoints[..., 2] > 0)
    return torch.clamp(y, 0, S - 1) * S + torch.clamp(x, 0, S - 1), valid


def keypoint_loss(heatmap_logits: torch.Tensor, keypoints: torch.Tensor, rois: torch.Tensor,
                  roi_valid: torch.Tensor) -> torch.Tensor:
    """Softmax CE over the flattened heatmap at each visible keypoint."""
    R, S, _, K = heatmap_logits.shape
    idx, kp_valid = keypoints_to_heatmap_targets(keypoints, rois, S)
    logits = heatmap_logits.reshape(R, S * S, K).transpose(1, 2).float()
    ce = torch.logsumexp(logits, dim=-1) - logits.gather(-1, idx.long()[..., None])[..., 0]
    w = (kp_valid & roi_valid.bool()[:, None]).float()
    return (ce * w).sum() / torch.clamp(w.sum(), min=1.0)


def pool_rois(features: torch.Tensor, rois: torch.Tensor, resolution: int,
              spatial_scale: float) -> torch.Tensor:
    """Single-level ROIAlign of image 0's ROIs [R, 4]."""
    batched = torch.cat([torch.zeros_like(rois[:, :1]), rois], dim=1)
    return roi_align(features, batched, out_size=resolution, spatial_scale=spatial_scale)
