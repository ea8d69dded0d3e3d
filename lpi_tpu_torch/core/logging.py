"""Metric logging: a jsonl stream, TensorBoard scalars, result files (host
copy of the parts of `lpi_tpu/core/logging.py` that the command line uses).

`MetricLogger` writes a `metrics.jsonl` stream and, given a directory,
TensorBoard scalars through `torch.utils.tensorboard`. `save_results_json`
writes the continual run's result file in the JAX package's schema
({session: {dataset: {'i2t' / 't2i': {task: [P@1, P@5, P@10]}}}} for
retrieval), so that `report` reads the files of either package.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

logger = logging.getLogger("lpi_tpu_torch")


def setup_logging(output_dir: Optional[str] = None, level=logging.INFO) -> logging.Logger:
    """stdout, and `<output_dir>/log.txt` when a directory is given."""
    logger.setLevel(level)
    logger.propagate = False  # no double lines when the root logger is configured
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s"))
        logger.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(output_dir, "log.txt"))
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s: %(message)s"))
        logger.addHandler(fh)
    return logger


class MetricLogger:
    """Metrics as a jsonl stream; with `tensorboard_dir`, every update also
    lands as TensorBoard scalars (left out when TensorBoard is not
    installed: the jsonl stream still works)."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None):
        if jsonl_path and os.path.dirname(jsonl_path):
            os.makedirs(os.path.dirname(jsonl_path), exist_ok=True)
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._tb = None
        self._tb_step = 0
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=tensorboard_dir)
            except ImportError:
                self._tb = None

    def update(self, **kwargs):
        if self._jsonl is not None:
            rec = {k: float(v) for k, v in kwargs.items()}
            rec["time"] = time.time()
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            self._tb_step += 1
            for k, v in kwargs.items():
                self._tb.add_scalar(k, float(v), self._tb_step)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def save_results_json(results: dict, output_dir: str, stem: Optional[str] = None) -> str:
    """Write the continual run's result dict to `<output_dir>/<stem>.json`
    (stem: a timestamp by default) and return the path."""
    os.makedirs(output_dir, exist_ok=True)
    stem = stem or time.strftime("%Y-%m-%d_%H-%M-%S")
    path = os.path.join(output_dir, f"{stem}.json")
    with open(path, "w") as f:
        json.dump(results, f, default=float)
    return path
