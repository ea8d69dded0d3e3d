"""Seeded weights made on the device in a few large draws.

A family's `rule(name, shape)` gives each parameter its law: ("normal",
std, keep), ("uniform", bound, keep) or ("const", value, keep); `keep`
(None for all) zeroes every element from that index on. All normal leaves
come from one `torch.randn` and all uniform ones from one `torch.rand`, on a
`torch.Generator` of the device seeded with the run's seed, so the same seed
gives the same bits on the same device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

Rule = Callable[[str, Tuple[int, ...]], Tuple[str, float, Optional[int]]]


def make(shapes: Dict[str, Sequence[int]], rule: Rule, seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: fp32 tensor on `device`} for every entry of `shapes`."""
    laws = {n: rule(n, tuple(s)) for n, s in shapes.items()}
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    out: Dict[str, torch.Tensor] = {}
    for kind in ("normal", "uniform"):
        names = [n for n in shapes if laws[n][0] == kind]
        sizes = [math.prod(shapes[n]) for n in names]
        if not names:
            continue
        draw = (torch.randn(sum(sizes), generator=g, device=device) if kind == "normal"
                else torch.rand(sum(sizes), generator=g, device=device) * 2 - 1)
        for n, part in zip(names, torch.split(draw, sizes)):
            out[n] = part.view(tuple(shapes[n])) * laws[n][1]
    for n, s in shapes.items():
        kind, value, keep = laws[n]
        if kind == "const":
            out[n] = torch.full(tuple(s), float(value), device=device)
        elif kind not in ("normal", "uniform"):
            raise ValueError(f"unknown law {kind!r} for {n}")
        if keep is not None:
            out[n].view(-1)[keep:] = 0.0
    return {n: out[n] for n in shapes}
