"""Metric logging: smoothed windows, ETA lines, a jsonl stream, TensorBoard
scalars, result files (host copy of `lpi_tpu/core/logging.py`).

`SmoothedValue` keeps a window of the last 20 values (median, average) and
the running mean of all of them. `MetricLogger` keeps one per metric
(`meters`), prints an ETA line (`log_line`), writes a `metrics.jsonl`
stream and, given a directory, TensorBoard scalars through
`torch.utils.tensorboard`. `save_results_json`
writes the continual run's result file in the JAX package's schema
({session: {dataset: {'i2t' / 't2i': {task: [P@1, P@5, P@10]}}}} for
retrieval), so that `report` reads the files of either package.
"""

from __future__ import annotations

import collections
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


class SmoothedValue:
    """Windowed median and average, and the global average
    (the reference's `utils/metric_logger.py` SmoothedValue)."""

    def __init__(self, window_size: int = 20):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        value = float(value)
        self.deque.append(value)
        self.total += value
        self.count += 1

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class MetricLogger:
    """Step metrics: a `SmoothedValue` per metric, an ETA line, a jsonl
    stream; with `tensorboard_dir`, every update also lands as TensorBoard
    scalars (left out when TensorBoard is not installed: the jsonl stream
    still works)."""

    def __init__(self, jsonl_path: Optional[str] = None, delimiter: str = "  ",
                 tensorboard_dir: Optional[str] = None):
        self.meters = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter
        if jsonl_path and os.path.dirname(jsonl_path):
            os.makedirs(os.path.dirname(jsonl_path), exist_ok=True)
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._start = time.time()
        self._tb = None
        self._tb_step = 0
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=tensorboard_dir)
            except ImportError:
                self._tb = None

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))
        if self._jsonl is not None:
            rec = {k: float(v) for k, v in kwargs.items()}
            rec["time"] = time.time()
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._tb is not None:
            self._tb_step += 1
            for k, v in kwargs.items():
                self._tb.add_scalar(k, float(v), self._tb_step)

    def log_line(self, step: int, total_steps: int, prefix: str = "") -> str:
        """`<prefix>[step/total]`, the ETA from the time since the logger
        was made, and each metric's windowed average; logged and
        returned."""
        elapsed = time.time() - self._start
        eta = elapsed / max(step, 1) * (total_steps - step)
        parts = [f"{prefix}[{step}/{total_steps}]", f"eta {eta:.0f}s"]
        parts += [f"{k} {m.avg:.4f}" for k, m in self.meters.items()]
        line = self.delimiter.join(parts)
        logger.info(line)
        return line

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
