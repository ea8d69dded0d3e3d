"""Task-similarity (MID) machinery (host copy of `lpi_tpu/continual/mid.py`).

The paper's recipe takes a 12 x 12 cosine-similarity matrix of text
embeddings of the 12 COCO supercategory names and thresholds it at 0.4 into
the binary task relation of the inter-task loss. The generation path
(embeddings -> cosine -> threshold) is a pure function so that any
embedding source works offline; `fallback_sim_matrix` stands in when there
is none.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# 12 COCO supercategories in task order: name -> task index.
SUPERCATEGORY_TO_TASK = {
    "appliance": 0, "sports": 1, "outdoor": 2, "electronic": 3,
    "accessory": 4, "indoor": 5, "kitchen": 6, "furniture": 7,
    "vehicle": 8, "food": 9, "animal": 10, "person": 11,
}
TASK_NAMES = tuple(
    name for name, _ in sorted(SUPERCATEGORY_TO_TASK.items(), key=lambda kv: kv[1])
)


def cosine_similarity_matrix(embeddings: np.ndarray) -> np.ndarray:
    """[T, D] embeddings -> [T, T] cosine matrix."""
    e = np.asarray(embeddings, np.float64)
    e = e / np.linalg.norm(e, axis=-1, keepdims=True)
    return e @ e.T


def load_task_sim_matrix(path: str, num_tasks: Optional[int] = None) -> np.ndarray:
    """Read a whitespace-separated similarity matrix (the
    `MID/task_sim_matrix.txt` format), cut to its first `num_tasks` rows and
    columns."""
    m = np.loadtxt(path)
    if num_tasks is not None:
        m = m[:num_tasks, :num_tasks]
    return m


def task_relation(sim_matrix: np.ndarray, threshold: float = 0.4) -> np.ndarray:
    """Binary task-relation matrix: sim > threshold."""
    return (np.asarray(sim_matrix) > threshold).astype(np.float32)


def fallback_sim_matrix(num_tasks: int, names: Sequence[str] = TASK_NAMES,
                        seed: int = 0) -> np.ndarray:
    """Deterministic stand-in when no embedding service is reachable: bag-of-
    character-bigram embeddings of the task names. Only the thresholded
    binary structure matters downstream; with english supercategory names
    this yields identity-dominant relations like the real matrix."""
    names = list(names)[:num_tasks]
    vocab = {}
    rows = []
    for name in names:
        grams = [name[i : i + 2] for i in range(len(name) - 1)]
        for g in grams:
            vocab.setdefault(g, len(vocab))
        rows.append(grams)
    embs = np.zeros((len(names), max(len(vocab), 1)))
    for i, grams in enumerate(rows):
        for g in grams:
            embs[i, vocab[g]] += 1.0
    return cosine_similarity_matrix(embs)
