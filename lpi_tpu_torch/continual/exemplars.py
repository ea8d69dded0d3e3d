"""Exemplar (rehearsal) memory with iCaRL-style herding (host copy of
`lpi_tpu/continual/exemplars.py`, numpy).

The reference's `BaseLearner` machinery (`retrieval/methods/base.py`):
feature-space herding selection, a fixed-budget store split evenly over
the seen classes, and nearest-mean-of-exemplars classification. Unused on
the LPI path (memory_size 0 in every config), kept as library API.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


def herding_selection(features: np.ndarray, m: int) -> np.ndarray:
    """iCaRL herding: greedily pick the indices whose running mean best
    tracks the class mean of the L2-normalised features."""
    features = np.asarray(features, np.float64)
    features = features / np.maximum(np.linalg.norm(features, axis=1, keepdims=True), 1e-9)
    mu = features.mean(axis=0)
    selected: List[int] = []
    acc = np.zeros_like(mu)
    m = min(m, len(features))
    for k in range(1, m + 1):
        target = mu * k - acc
        scores = features @ target
        scores[selected] = -np.inf
        i = int(np.argmax(scores))
        selected.append(i)
        acc += features[i]
    return np.asarray(selected, np.int64)


@dataclass
class ExemplarMemory:
    """A fixed total budget split evenly across the seen classes."""

    memory_size: int = 0
    store: Dict[int, dict] = field(default_factory=dict)

    @property
    def per_class(self) -> int:
        return self.memory_size // max(len(self.store), 1)

    def update(self, class_id: int, features: np.ndarray, payload=None):
        """Add a class; reselect every class's exemplars so that the budget
        stays balanced."""
        if self.memory_size <= 0:
            return
        self.store[class_id] = {"features": np.asarray(features), "payload": payload}
        budget = self.memory_size // len(self.store)
        for entry in self.store.values():
            feats = entry["features"]
            entry["selected"] = herding_selection(feats, min(budget, len(feats)))

    def exemplars(self, class_id: int) -> np.ndarray:
        entry = self.store.get(class_id)
        if entry is None:
            return np.zeros((0,), np.int64)
        return entry.get("selected", np.zeros((0,), np.int64))

    def class_means(self) -> Dict[int, np.ndarray]:
        out = {}
        for cid, entry in self.store.items():
            idx = entry.get("selected")
            feats = entry["features"]
            sel = feats[idx] if idx is not None and len(idx) else feats
            sel = sel / np.maximum(np.linalg.norm(sel, axis=1, keepdims=True), 1e-9)
            out[cid] = sel.mean(axis=0)
        return out

    def nme_classify(self, features: np.ndarray) -> np.ndarray:
        """Nearest-mean-of-exemplars prediction (`base.py:_eval_nme`)."""
        means = self.class_means()
        if not means:
            return np.zeros(len(features), np.int64)
        classes = sorted(means)
        mat = np.stack([means[c] for c in classes])  # [C, D]
        f = np.asarray(features, np.float64)
        f = f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-9)
        d = ((f[:, None, :] - mat[None, :, :]) ** 2).sum(-1)
        return np.asarray(classes)[np.argmin(d, axis=1)]
