"""Offline result post-processing (host copy of
`lpi_tpu/eval/reshandle.py`).

Reads a continual run's result json ({session: {dataset: {'i2t' / 't2i':
{task: [P@1, P@5, P@10]}}}}, as `core.logging.save_results_json` writes it
in either package) and reports, per k, the task-weighted average precision
of the final session and the forgetting (best earlier session minus the
final one). The default weights are the RefCOCO val per-task sample counts
of the paper's recipe.
"""

from __future__ import annotations

import json
from typing import Dict, Sequence

import numpy as np

from lpi_tpu_torch.eval.retrieval import aggregate_results

DEFAULT_TASK_WEIGHTS = (73, 27, 44, 255, 210, 306, 474, 500, 500, 500, 500, 500)


def _normalize_sessions(raw: dict, dataset: str) -> Dict[int, dict]:
    sessions = {}
    for s_key, entry in raw.items():
        body = entry.get(dataset, entry) if isinstance(entry, dict) else entry
        sessions[int(s_key)] = {d: {int(t): v for t, v in body[d].items()}
                                for d in ("i2t", "t2i") if d in body}
    return sessions


def get_res(json_file: str, dataset: str = "mscoco", metric: str = "i2t",
            num_sessions: int = 12,
            weights: Sequence[float] = DEFAULT_TASK_WEIGHTS) -> dict:
    """-> {'P@1', 'forgetting@1', 'P@5', 'forgetting@5', 'P@10',
    'forgetting@10', 'mean'} over the first `num_sessions` sessions."""
    with open(json_file) as f:
        raw = json.load(f)
    sessions = _normalize_sessions(raw, dataset)
    sessions = {s: sessions[s] for s in range(min(num_sessions, len(sessions)))}
    out = {}
    for k_index, k in enumerate((1, 5, 10)):
        agg = aggregate_results(sessions, direction=metric, k_index=k_index, weights=weights)
        out[f"P@{k}"] = agg["average"]
        out[f"forgetting@{k}"] = agg["forgetting"]
    out["mean"] = float(np.mean([out["P@1"], out["P@5"], out["P@10"]]))
    return out
