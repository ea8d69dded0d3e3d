"""The generator of grounding requests: COCO-sized images (long side
`long_side`, short side drawn from `short_side`, landscape or portrait) and
referring expressions of `words` [lo, hi] words drawn from a list with no
verb, preposition or article, so that each caption names one entity.
Images are made on the device from the seed (coarse noise upsampled, with
fine noise) and handed to the program as uint8 host arrays.

Parameters (a traffic file): `count` (distinct requests, sent in turn),
`long_side`, `short_side` [lo, hi], `words` [lo, hi], `image_grid`.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

WORDS = ("red", "blue", "green", "white", "black", "yellow", "large", "small", "tall",
         "short", "old", "young", "wooden", "striped", "left", "right", "front", "back",
         "middle", "dog", "cat", "man", "woman", "boy", "girl", "car", "bus", "truck", "bike",
         "horse", "table", "chair", "couch", "lamp", "tree", "cup", "plate", "bowl", "laptop",
         "phone", "umbrella", "kite", "bag", "bottle", "person", "sheep", "zebra", "clock")


def requests(params: dict, conf: dict, seed: int, device) -> List[Tuple[np.ndarray, str]]:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2 + 1) % (2 ** 63))
    lo, hi = params["short_side"]
    wl, wh = params["words"]
    grid = params["image_grid"]
    out = []
    for _ in range(params["count"]):
        short = int(torch.randint(lo, hi + 1, (1,), generator=g, device=device))
        long = params["long_side"]
        wide = bool(torch.randint(0, 2, (1,), generator=g, device=device))
        H, W = (short, long) if wide else (long, short)
        coarse = torch.randn(1, 3, grid, grid, generator=g, device=device)
        img = F.interpolate(coarse, size=(H, W), mode="bilinear", align_corners=False)
        img = img + 0.2 * torch.randn(img.shape, generator=g, device=device)
        u8 = (torch.sigmoid(img) * 255).round().to(torch.uint8)[0].permute(1, 2, 0)
        n = int(torch.randint(wl, wh + 1, (1,), generator=g, device=device))
        idx = torch.randint(0, len(WORDS), (n,), generator=g, device=device).tolist()
        out.append((u8.contiguous().cpu().numpy(), " ".join(WORDS[i] for i in idx)))
    return out
