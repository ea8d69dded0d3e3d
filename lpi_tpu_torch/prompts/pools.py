"""Task-wise LPI prompt pool (counterpart of `lpi_tpu/prompts/pools.py`).

Each CP factor is one parameter with a leading [num_tasks] axis:

    prompt[l, p, d] = mean_r( d1_share[l, r] * d2[p, r] * d3[d, r] )

with a per-layer factor shared across modalities and per-token /
per-channel factors per modality. Only the `"lpi"` prompt type is ported.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn


def compose_cp(d1: torch.Tensor, d2: torch.Tensor, d3: torch.Tensor) -> torch.Tensor:
    """d1 [..., L, r], d2 [..., P, r], d3 [..., D, r] -> [..., L, P, D]."""
    r = d1.shape[-1]
    return torch.einsum("...lr,...pr,...dr->...lpd", d1, d2, d3) / r


class DecomposedPromptPool(nn.Module):
    """Rank-r CP-factorised prompts for all tasks at once."""

    def __init__(self, num_tasks: int, layer_num: int, prompt_num: int,
                 visual_dim: int, textual_dim: int, rank: int = 4):
        super().__init__()
        T, L, P, r = num_tasks, layer_num, prompt_num, rank
        self.d1_share = nn.Parameter(torch.zeros(T, L, r))
        self.d2_visual = nn.Parameter(torch.zeros(T, P, r))
        self.d2_textual = nn.Parameter(torch.zeros(T, P, r))
        self.d3_visual = nn.Parameter(torch.zeros(T, visual_dim, r))
        self.d3_textual = nn.Parameter(torch.zeros(T, textual_dim, r))

    def forward(self, task_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prompts of one task: ([L, P, Dv], [L, P, Dt])."""
        d1 = self.d1_share[task_id]
        return (compose_cp(d1, self.d2_visual[task_id], self.d3_visual[task_id]),
                compose_cp(d1, self.d2_textual[task_id], self.d3_textual[task_id]))

    def all_prompts(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full stacks: ([T, L, P, Dv], [T, L, P, Dt])."""
        return (compose_cp(self.d1_share, self.d2_visual, self.d3_visual),
                compose_cp(self.d1_share, self.d2_textual, self.d3_textual))
