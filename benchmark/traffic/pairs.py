"""The generator of image-caption training batches, as the retrieval
bench makes them: images N(0, 1), token ids uniform in [1, 49000) with
CLIP's start and end tokens first and last; made on the device from the
seed and handed to the program as host arrays.

Parameters (a traffic file): `batch`, `ring` (distinct batches made, used
in turn). The image side and the context length come from the
configuration's `retrieval.clip` tree.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

SOT, EOT = 49406, 49407


def batches(params: dict, conf: dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    c = conf["retrieval"]["clip"]
    image_size, context = c["image_resolution"], c["context_length"]
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2 + 1) % (2 ** 63))
    B = params["batch"]
    out = []
    for _ in range(params["ring"]):
        images = torch.randn(B, image_size, image_size, 3, generator=g, device=device)
        ids = torch.randint(1, 49000, (B, context), generator=g, device=device)
        ids[:, 0] = SOT
        ids[:, -1] = EOT
        out.append({"images": images.cpu().numpy(), "token_ids": ids.cpu().numpy()})
    return out
