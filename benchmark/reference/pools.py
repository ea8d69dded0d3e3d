"""Frozen copy of the port's `lpi_tpu_torch/prompts/pools.py` for the
benchmark's reference. Task-wise prompt pools.

Every pool parameter has a leading axis that a session's step masks with
the one-hot of its task: [num_tasks] for the per-task pools, [pool_size]
(= the number of sessions) for L2P's shared pool.

* `DecomposedPromptPool` ("lpi"): rank-r CP factors,
  prompt[l, p, d] = mean_r( d1_share[l, r] * d2[p, r] * d3[d, r] ), with a
  per-layer factor shared across modalities; factors ~ N(0, 0.5).
* `NormalPromptPool` ("sprompts"): dense per-task prompts, N(0, 0.02).
* `MaPLePromptPool` (grounding "maple"): per-task textual prompts, N(0,
  0.02), and per-layer projections U(+-1/sqrt(Dt)) that make the visual
  prompts from them.
* `L2pPrompt` ("l2p", retrieval): a shared pool with keys, U(-1, 1); each
  sample picks its top-k keys by cosine, a batchwise majority vote picks
  the pool entries, and they overwrite the leading tokens of the embedding.

Each pool's `init_leaf_` draws its leaves from the JAX package's
distributions. `build_prompt_pool` maps a retrieval `prompt_type` to its
pool ("lpi", "sprompts", "l2p") as the JAX package does; MaPLe is built by
the grounding model alone.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from benchmark.reference.layers import normal_, uniform_


def compose_cp(d1: torch.Tensor, d2: torch.Tensor, d3: torch.Tensor) -> torch.Tensor:
    """d1 [..., L, r], d2 [..., P, r], d3 [..., D, r] -> [..., L, P, D]."""
    r = d1.shape[-1]
    return torch.einsum("...lr,...pr,...dr->...lpd", d1, d2, d3) / r


def task_row(p: torch.Tensor, task_id) -> torch.Tensor:
    """Row `task_id` of p's leading axis. `task_id` is an int or a 0-d
    integer tensor on p's device (a gather, so no host sync)."""
    if isinstance(task_id, torch.Tensor):
        return p.index_select(0, task_id.reshape(1))[0]
    return p[task_id]


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

    def init_leaf_(self, leaf: str, p: torch.Tensor, generator: torch.Generator) -> None:
        normal_(p, 0.5, generator)

    def forward(self, task_id) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prompts of one task: ([L, P, Dv], [L, P, Dt])."""
        def take(p):
            return task_row(p, task_id)
        d1 = take(self.d1_share)
        return (compose_cp(d1, take(self.d2_visual), take(self.d3_visual)),
                compose_cp(d1, take(self.d2_textual), take(self.d3_textual)))

    def all_prompts(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full stacks: ([T, L, P, Dv], [T, L, P, Dt])."""
        return (compose_cp(self.d1_share, self.d2_visual, self.d3_visual),
                compose_cp(self.d1_share, self.d2_textual, self.d3_textual))

    def gather(self, task_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-sample prompts: task_ids [B] -> ([B, L, P, Dv], [B, L, P, Dt]),
        all tasks composed, then one gather (T is small)."""
        vis, txt = self.all_prompts()
        return vis.index_select(0, task_ids), txt.index_select(0, task_ids)


class NormalPromptPool(nn.Module):
    """Dense per-task prompts (the S-Prompts baseline)."""

    def __init__(self, num_tasks: int, layer_num: int, prompt_num: int,
                 visual_dim: int, textual_dim: int):
        super().__init__()
        T, L, P = num_tasks, layer_num, prompt_num
        self.visual_prompt = nn.Parameter(torch.zeros(T, L, P, visual_dim))
        self.textual_prompt = nn.Parameter(torch.zeros(T, L, P, textual_dim))

    def init_leaf_(self, leaf: str, p: torch.Tensor, generator: torch.Generator) -> None:
        normal_(p, 0.02, generator)

    def forward(self, task_id) -> Tuple[torch.Tensor, torch.Tensor]:
        return task_row(self.visual_prompt, task_id), task_row(self.textual_prompt, task_id)

    def all_prompts(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.visual_prompt, self.textual_prompt

    def gather(self, task_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self.visual_prompt.index_select(0, task_ids),
                self.textual_prompt.index_select(0, task_ids))


class MaPLePromptPool(nn.Module):
    """MaPLe coupled prompts, task-indexed: textual prompts [T, L, P, Dt] and
    per-layer projections [T, L, Dt, Dv] + [T, L, Dv] that make the visual
    prompts [L, P, Dv] from them. The fused encoder replaces tokens with
    them instead of adding (`interact_type="maple"`)."""

    def __init__(self, num_tasks: int, layer_num: int, prompt_num: int,
                 visual_dim: int, textual_dim: int):
        super().__init__()
        T, L, P = num_tasks, layer_num, prompt_num
        self.textual = nn.Parameter(torch.zeros(T, L, P, textual_dim))
        self.proj_kernel = nn.Parameter(torch.zeros(T, L, textual_dim, visual_dim))
        self.proj_bias = nn.Parameter(torch.zeros(T, L, visual_dim))

    def init_leaf_(self, leaf: str, p: torch.Tensor, generator: torch.Generator) -> None:
        if leaf == "textual":
            normal_(p, 0.02, generator)
        else:
            uniform_(p, self.textual.shape[-1] ** -0.5, generator)

    def forward(self, task_id) -> Tuple[torch.Tensor, torch.Tensor]:
        t = task_row(self.textual, task_id)
        vis = torch.einsum("lpt,ltv->lpv", t, task_row(self.proj_kernel, task_id))
        return vis + task_row(self.proj_bias, task_id)[:, None, :], t

    def all_prompts(self) -> Tuple[torch.Tensor, torch.Tensor]:
        vis = torch.einsum("alpt,altv->alpv", self.textual, self.proj_kernel)
        return vis + self.proj_bias[:, :, None, :], self.textual

    def gather(self, task_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        vis, txt = self.all_prompts()
        return vis.index_select(0, task_ids), txt.index_select(0, task_ids)


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x * rsqrt(max(sum(x^2), eps)) in x's dtype, the rsqrt taken in fp32
    and rounded once (as XLA computes a bf16 rsqrt)."""
    sq = torch.clamp((x * x).sum(dim, keepdim=True), min=eps)
    return x * torch.rsqrt(sq.float()).to(x.dtype)


class L2pPrompt(nn.Module):
    """L2P prompt pool with key matching, shapes static: each sample's top-k
    pool entries by the cosine of its mean token to the keys, then the
    batchwise majority (a fixed-size count over the pool, ties to the lower
    index as `jax.lax.top_k` breaks them); the chosen prompts overwrite the
    first top_k * length tokens of the embedding, the class token included.
    (The JAX package's per-sample choice and "max" keys have no caller.)"""

    def __init__(self, pool_size: int = 12, length: int = 4, embed_dim: int = 96,
                 top_k: int = 4):
        super().__init__()
        self.pool_size, self.length, self.embed_dim = pool_size, length, embed_dim
        self.top_k = top_k
        self.prompt = nn.Parameter(torch.zeros(pool_size, length, embed_dim))
        self.prompt_key = nn.Parameter(torch.zeros(pool_size, embed_dim))

    def init_leaf_(self, leaf: str, p: torch.Tensor, generator: torch.Generator) -> None:
        uniform_(p, 1.0, generator)

    @staticmethod
    def _top(x: torch.Tensor, k: int) -> torch.Tensor:
        """Indices of the k largest along the last axis, ties to the lower
        index (a stable descending sort: `torch.topk` promises no order)."""
        return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]

    def forward(self, x_embed: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x_embed [B, N, D] -> {prompted_embedding [B, N, D], prompt_idx
        [B, top_k], similarity [B, pool] fp32, reduce_sim (0-d fp32),
        total_prompt_len}. The mean and the normalisation of the embedding
        run in its dtype, the similarity in fp32, as the JAX package
        promotes them."""
        # summed in fp32 and rounded once, as `jnp.mean`
        feat = x_embed.float().mean(1).to(x_embed.dtype)
        B = x_embed.shape[0]
        key_norm = _l2_normalize(self.prompt_key)  # [S, D] fp32
        feat_norm = _l2_normalize(feat).float()  # [B, D]
        similarity = feat_norm @ key_norm.T  # [B, S]
        k = min(self.top_k, self.pool_size)
        idx = self._top(similarity, k)  # [B, k]
        # a count per pool entry, a fixed [S] (bincount reads its length back
        # to the host, which a captured step cannot)
        pool = torch.arange(self.pool_size, device=idx.device)
        counts = (idx.reshape(-1, 1) == pool).sum(0)
        idx = self._top(counts, k)[None].expand(B, k)
        batched = self.prompt.index_select(0, idx.reshape(-1))
        batched = batched.reshape(B, k * self.length, self.embed_dim)
        selected_key = key_norm.index_select(0, idx.reshape(-1)).reshape(B, k, -1)
        reduce_sim = (selected_key * feat_norm[:, None, :]).sum() / B
        total = k * self.length
        if total > x_embed.shape[1]:  # the JAX package's `.at[].set` refuses it too
            raise ValueError(f"{total} prompt tokens do not fit {x_embed.shape[1]} tokens")
        prompted = torch.cat([batched.to(x_embed.dtype), x_embed[:, total:]], dim=1)
        return {"prompted_embedding": prompted, "prompt_idx": idx, "similarity": similarity,
                "reduce_sim": reduce_sim, "total_prompt_len": total}


def build_prompt_pool(prompt_type: str, num_tasks: int, layer_num: int, prompt_num: int,
                      visual_dim: int, textual_dim: int, rank: int = 4, l2p_length: int = 4,
                      l2p_top_k: int = 4) -> nn.Module:
    """The pool of a retrieval `prompt_type`: "lpi", "sprompts" (one layer)
    or "l2p" (`num_tasks` entries at `visual_dim`); anything else is a
    ValueError, as in the JAX package's dispatch (whose L2P pool takes the
    defaults of `l2p_length` and `l2p_top_k`)."""
    if prompt_type == "lpi":
        return DecomposedPromptPool(num_tasks, layer_num, prompt_num, visual_dim,
                                    textual_dim, rank)
    if prompt_type == "sprompts":
        return NormalPromptPool(num_tasks, 1, prompt_num, visual_dim, textual_dim)
    if prompt_type == "l2p":
        return L2pPrompt(pool_size=num_tasks, length=l2p_length, embed_dim=visual_dim,
                         top_k=l2p_top_k)
    raise ValueError(f"unknown prompt_type {prompt_type!r}")
