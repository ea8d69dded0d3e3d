"""Deterministic k-means for the task keys (counterpart of
`lpi_tpu/ops/kmeans.py`): k-means++ seeding, a fixed number of Lloyd
iterations, several restarts picked by inertia, all in fp32 with TF32 off.

The seeding draws from a `torch.Generator` (a CPU generator; the draws are
moved to the features' device): `jax.random` bits cannot be reproduced, so
the tests hand both packages the same initial centres and compare the Lloyd
iterations.
"""

from __future__ import annotations

from typing import Tuple

import torch

from lpi_tpu_torch.continual.keys import exact_fp32


def _plusplus_init(generator: torch.Generator, x: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding: x [N, D] -> centres [k, D]; each new centre is drawn
    with probability proportional to the squared distance to the nearest
    chosen one (Gumbel-max over log d^2)."""
    n = x.shape[0]
    first = int(torch.randint(n, (), generator=generator))
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    for i in range(1, k):
        d2 = ((x[:, None, :] - centers[None, :i, :]) ** 2).sum(-1).min(dim=1).values
        logits = torch.log(torch.clamp(d2, min=1e-12))
        u = torch.rand(n, generator=generator, dtype=torch.float64).clamp_(1e-300, 1.0)
        gumbel = (-torch.log(-torch.log(u))).to(x.dtype).to(x.device)
        centers[i] = x[torch.argmax(logits + gumbel)]
    return centers


def lloyd(x: torch.Tensor, centers: torch.Tensor, iters: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`iters` Lloyd steps from `centers`; an empty cluster keeps its old
    centre. -> (centres [k, D], inertia)."""
    k = centers.shape[0]
    for _ in range(iters):
        d2 = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        onehot = torch.nn.functional.one_hot(torch.argmin(d2, dim=1), k).to(x.dtype)
        counts = onehot.sum(0)
        new = (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None]
        centers = torch.where(counts[:, None] > 0, new, centers)
    d2 = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    return centers, d2.min(dim=1).values.sum()


def kmeans(x: torch.Tensor, generator: torch.Generator, k: int = 5, iters: int = 50,
           restarts: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster x [N, D] into k centres -> (centres [k, D], inertia), the best
    of `restarts` runs seeded from `generator`."""
    with torch.no_grad(), exact_fp32():
        x = x.float()
        runs = [lloyd(x, _plusplus_init(generator, x, k), iters) for _ in range(restarts)]
        best = int(torch.argmin(torch.stack([inertia for _, inertia in runs])))
    return runs[best]
