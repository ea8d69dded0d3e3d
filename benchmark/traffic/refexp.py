"""The generator of referring-expression training batches (RefCOCO-style:
one image, one box and one expression an example), made on the device from
the seed and handed to the program as host arrays.

Parameters (a traffic file): `batch`, `ring` (distinct batches made, used
in turn), `words` [lo, hi] (expression length in words), `entity_words`
[lo, hi] (the words of the expression that name the box, from the first),
`box_side` [lo, hi] (box side over the image side), `image_grid` (the side
of the coarse noise that is upsampled into the image). The image side,
the text length, the vocabulary and the box count come from the
configuration's `grounding` tree.

Token ids are [CLS] w1 .. wn [SEP] then padding 0, the words drawn from
[1000, vocab); the positive map marks the entity's tokens with 1.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

CLS, SEP = 101, 102


def batches(params: dict, conf: dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    c = conf["grounding"]
    image_size, max_boxes = c["image_size"], c["max_boxes"]
    max_len, vocab = c["bert"]["max_query_len"], c["bert"]["vocab_size"]
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2 + 1) % (2 ** 63))
    B, R = params["batch"], params["ring"]
    out = []
    for _ in range(R):
        grid = params["image_grid"]
        coarse = torch.randn(B, 3, grid, grid, generator=g, device=device)
        img = F.interpolate(coarse, size=(image_size, image_size), mode="bilinear",
                            align_corners=False)
        img = img + 0.1 * torch.randn(img.shape, generator=g, device=device)
        lo, hi = params["box_side"]
        side = lo + (hi - lo) * torch.rand(B, 2, generator=g, device=device)
        wh = side * image_size
        xy = torch.rand(B, 2, generator=g, device=device) * (image_size - wh)
        boxes = torch.zeros(B, max_boxes, 4, device=device)
        boxes[:, 0, :2] = xy
        boxes[:, 0, 2:] = xy + wh
        valid = torch.zeros(B, max_boxes, dtype=torch.bool, device=device)
        valid[:, 0] = True
        wl, wh_ = params["words"]
        n = torch.randint(wl, wh_ + 1, (B,), generator=g, device=device)
        el, eh = params["entity_words"]
        e = torch.minimum(torch.randint(el, eh + 1, (B,), generator=g, device=device), n)
        words = torch.randint(1000, vocab, (B, max_len), generator=g, device=device)
        pos = torch.arange(max_len, device=device)[None]
        ids = torch.where((pos >= 1) & (pos <= n[:, None]), words, torch.zeros_like(words))
        ids[:, 0] = CLS
        ids = torch.where(pos == n[:, None] + 1, torch.full_like(ids, SEP), ids)
        mask = (pos <= n[:, None] + 1).float()
        ent = ((pos >= 1) & (pos <= e[:, None])).float()
        pmap = torch.zeros(B, max_boxes, max_len, device=device)
        pmap[:, 0] = ent
        out.append({"images": img.permute(0, 2, 3, 1).contiguous().cpu().numpy(),
                    "input_ids": ids.cpu().numpy(), "attention_mask": mask.cpu().numpy(),
                    "gt_boxes": boxes.cpu().numpy(), "gt_valid": valid.cpu().numpy(),
                    "positive_map": pmap.cpu().numpy()})
    return out
