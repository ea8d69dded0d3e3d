"""Task-identity keys: per-task KMeans centers and nearest-center inference
(counterpart of `lpi_tpu/continual/keys.py`).

Each sample picks the task whose closest center is nearest in the L1
metric, with first-occurrence argmin over tasks; untrained tasks are
masked with +inf. The path runs in full fp32: reduced matmul precision once
moved the task-ID accuracy far on the chip, so TF32 stays off around it
(`exact_fp32`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch


@contextlib.contextmanager
def exact_fp32():
    """Turn TF32 off for cuBLAS matmuls and cuDNN convolutions inside the
    block, restoring both flags after it."""
    mm, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn


@dataclass(frozen=True)
class TaskKeys:
    centers: torch.Tensor  # [num_tasks, k, dim] fp32
    valid: torch.Tensor  # [num_tasks] bool, sessions trained so far

    def to(self, device) -> "TaskKeys":
        return TaskKeys(self.centers.to(device), self.valid.to(device))


def infer_task_ids(features: torch.Tensor, keys: TaskKeys) -> torch.Tensor:
    """features [B, D] -> task ids [B] by nearest center, L1 metric."""
    d = (features.float()[:, None, None, :] - keys.centers[None]).abs().sum(-1)
    per_task = d.min(dim=2).values  # [B, T]
    per_task = torch.where(keys.valid[None, :], per_task,
                           torch.full_like(per_task, float("inf")))
    return torch.argmin(per_task, dim=1)
