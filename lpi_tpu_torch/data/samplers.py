"""Grouped batch sampling for multi-scale training (host copy of
`lpi_tpu/data/samplers.py`).

The reference's `GroupedBatchSampler` emits batches whose elements share one
group id, so a batch never mixes shapes. Multi-scale training
(`AugmentConfig.multi_scale`) offers two static-shape strategies:

* pad-to-max (`GroundingTaskSet.batches`): one shape, one captured step,
  and a padding waste of `1 - mean(s^2) / max(s)^2` (about 40% for
  480..800);
* scale-grouped (`GroundingTaskSet.batches_grouped`): each batch at its own
  scale's shape, one captured step per scale, no padding. The grouping is
  here.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np


class GroupedBatchSampler:
    """Batches of indices, each within one group: the elements are taken in
    a shuffled order (numpy RandomState(seed)) and buffered per group, and
    a batch leaves as soon as its group holds `batch_size`. Without
    `drop_uneven` the partial batches follow at the end in group order, so
    every element appears once an epoch."""

    def __init__(self, group_ids: Sequence[int], batch_size: int,
                 seed: int = 0, drop_uneven: bool = False):
        self.group_ids = np.asarray(group_ids)
        self.batch_size = int(batch_size)
        self.seed = seed
        self.drop_uneven = drop_uneven

    def __iter__(self) -> Iterator[List[int]]:
        order = np.random.RandomState(self.seed).permutation(len(self.group_ids))
        buffers: Dict[int, List[int]] = {}
        for idx in order:
            buf = buffers.setdefault(int(self.group_ids[idx]), [])
            buf.append(int(idx))
            if len(buf) == self.batch_size:
                yield list(buf)
                buf.clear()
        if not self.drop_uneven:
            for g in sorted(buffers):
                if buffers[g]:
                    yield list(buffers[g])

    def __len__(self) -> int:
        if self.drop_uneven:
            _, counts = np.unique(self.group_ids, return_counts=True)
            return int(sum(c // self.batch_size for c in counts))
        return sum(1 for _ in self)


def draw_scales(num_examples: int, scales: Sequence[int], seed: int) -> np.ndarray:
    """Each example's scale, drawn up front (uniform over `scales`, numpy
    RandomState(seed)) so that batches can be grouped by it."""
    rng = np.random.RandomState(seed)
    return np.asarray(scales)[rng.randint(0, len(scales), size=num_examples)]


def padding_waste(scales: Sequence[int], padded: int) -> float:
    """The share of a batch's pixels that is padding under pad-to-`padded`."""
    s = np.asarray(scales, np.float64)
    return float(1.0 - np.mean(s * s) / (padded * padded))
