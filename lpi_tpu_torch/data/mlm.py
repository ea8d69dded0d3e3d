"""Masked-language-modelling caption masking (host copy of
`lpi_tpu/data/mlm.py`, GLIP's `random_word`).

BERT's policy: 15% of the non-special tokens are chosen; of those 80% become
[MASK], 10% a random id and 10% stay; the labels hold the chosen tokens' ids
and IGNORE_INDEX elsewhere. The MLM loss is off in every LPI config; the
masking is here for parity. Numpy, deterministic under a seeded RandomState
(the same draws, in the same order, as the JAX package).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

IGNORE_INDEX = -100


def random_word(input_ids: np.ndarray, rng: np.random.RandomState, mask_token_id: int,
                vocab_size: int, special_ids: Tuple[int, ...] = (0, 101, 102),
                mlm_probability: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """-> (masked input_ids, labels)."""
    input_ids = np.asarray(input_ids)
    masked = input_ids.copy()
    labels = np.full_like(input_ids, IGNORE_INDEX)
    candidates = ~np.isin(input_ids, special_ids)
    selected = candidates & (rng.rand(*input_ids.shape) < mlm_probability)
    labels[selected] = input_ids[selected]

    action = rng.rand(*input_ids.shape)
    to_mask = selected & (action < 0.8)
    to_random = selected & (action >= 0.8) & (action < 0.9)
    masked[to_mask] = mask_token_id
    masked[to_random] = rng.randint(0, vocab_size, size=int(to_random.sum()))
    return masked, labels
