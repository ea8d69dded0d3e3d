"""GPipe pipeline parallelism over a process group (counterpart of
`lpi_tpu/core/pipeline.py`).

The reference has no pipeline parallelism; the JAX package adds it as a
scaling dimension beside data and tensor parallelism, and so does the
port, with the same schedule:

* the layer list (`L` blocks) is cut into `S` stages of `L/S` consecutive
  blocks, stage s on rank s of the pipeline group;
* the batch is cut into `M` microbatches streamed through the stages in
  `M + S - 1` ticks: at tick t, stage s runs microbatch t - s; a stage
  with no microbatch at a tick (the fill and the drain) runs on the
  nearest one's rows and its result is dropped, as in the JAX package;
* activations move from stage s to s + 1 at the end of every tick
  (`isend` / `irecv`, one pair a tick); backward, the gradients move the
  other way, so the whole pipeline is differentiable by autograd. Each
  rank differentiates its own part, so every rank's backward must pass
  every tick's exchange, in the same order: each tick's output depends on
  the tensor received at that tick (stage 0 adds it times 0 to its
  input), and every rank's output adds the last received tensor times 0;
* the last stage's outputs are summed over the group (every other stage
  gives zeros), so every rank returns the whole output; backward, the
  last stage takes the gradient as it is (every rank's loss is the same).

With `data_group`, each microbatch's rows are further sharded over that
group (dp x pp): this rank runs its rows, and the outputs are gathered
back (`core.dist.gather_rows`), so every rank returns the global output;
the gradients of the stages' parameters then want averaging over
`data_group`, as in the data-parallel steps.

`pipeline_scan` takes any per-layer body; `pipeline_tower` pipelines a
CLIP tower's block list (`models.clip.model.ResidualAttentionBlock`) with
per-layer, per-sample prompts added at slots [1, 1 + P) by a gate, the
JAX package's `PromptedBlock`. No learner calls either, as none does in
the JAX package; the dryrun and the tests do.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from lpi_tpu_torch.core import dist as dist_lib


class _Shift(torch.autograd.Function):
    """Stage s's tensor to stage s + 1 (the last stage sends nothing, the
    first receives zeros); backward, the gradient to stage s - 1."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _exchange(y, group, forward=True)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad.contiguous(), ctx.group, forward=False), None


def _exchange(t: torch.Tensor, group, forward: bool) -> torch.Tensor:
    s, S = dist.get_rank(group), dist.get_world_size(group)
    to, frm = (s + 1, s - 1) if forward else (s - 1, s + 1)
    out = torch.zeros_like(t)
    ops = []
    if 0 <= to < S:
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dist.get_global_rank(group, to),
                              group))
    if 0 <= frm < S:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, frm), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


class _FromLast(torch.autograd.Function):
    """The last stage's tensor on every rank (a sum where every other stage
    gives zeros); backward, the gradient as it is."""

    @staticmethod
    def forward(ctx, y, group):
        out = y.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def pipeline_scan(group, body_fn: Callable, layers: Sequence, x: torch.Tensor, *,
                  microbatches: int, layered_mb: Optional[Sequence[torch.Tensor]] = None,
                  data_group=None) -> torch.Tensor:
    """Run `x -> body_fn(layers[L-1], ., ... body_fn(layers[0], ., x))` as an
    S-stage GPipe pipeline over `group` (S = its size).

    `body_fn(layer, mb, h) -> h`: one layer's computation, `layer` an entry
    of `layers` (the L layers, L % S == 0; stage s runs entries
    [s L/S, (s+1) L/S)), `mb` the tuple of `layered_mb` entries at this
    layer, rows of this microbatch (None without `layered_mb`). `x`
    [B, ...] with B % M == 0; `layered_mb`: tensors [L, B, ...] of
    per-layer, per-sample values. `data_group`: shard each microbatch's
    rows over it (dp x pp). -> [B, ...] on every rank."""
    S, s = dist.get_world_size(group), dist.get_rank(group)
    L = len(layers)
    if L % S:
        raise ValueError(f"layer count {L} not divisible by {S} stages")
    B, M = x.shape[0], microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    b = B // M
    rows = [torch.arange(m * b, (m + 1) * b, device=x.device) for m in range(M)]
    if data_group is not None:
        d, D = dist.get_rank(data_group), dist.get_world_size(data_group)
        if b % D:
            raise ValueError(f"microbatch {b} not divisible by data-parallel {D}")
        rows = [r[d * (b // D):(d + 1) * (b // D)] for r in rows]
    per = L // S
    mine = range(s * per, (s + 1) * per)

    def run_layers(h, m):
        for l in mine:
            mb = None if layered_mb is None else tuple(v[l][rows[m]] for v in layered_mb)
            h = body_fn(layers[l], mb, h)
        return h

    state = torch.zeros_like(x[rows[0]])
    outs = [None] * M
    for t in range(M + S - 1):
        m = min(max(t - s, 0), M - 1)  # the fill and the drain: rows dropped below
        y = run_layers(x[rows[m]] + 0 * state if s == 0 else state, m)
        if s == S - 1 and t >= S - 1:
            outs[t - (S - 1)] = y
        if S > 1:
            state = _Shift.apply(y, group)
    out = (torch.stack(outs) if s == S - 1 else torch.zeros((M,) + state.shape,
                                                          dtype=x.dtype, device=x.device))
    if S > 1:
        out = out + 0 * state.sum()
    out = _FromLast.apply(out, group)  # [M, rows, ...]
    if data_group is not None:
        out = dist_lib.gather_rows(out.transpose(0, 1), data_group).transpose(0, 1)
    return out.reshape((B,) + x.shape[1:])


def pipeline_tower(group, blocks, x: torch.Tensor, prompts: torch.Tensor,
                   gates: torch.Tensor, *, microbatches: int = 4, token_offset: int = 1,
                   data_group=None) -> torch.Tensor:
    """Pipeline a CLIP tower's blocks over `group`: `blocks` the L
    `ResidualAttentionBlock`s, `x` [B, S, D] the tokens entering layer 0,
    `prompts` [L, B, P, D] (or [L, 1, P, D], shared by the batch) and
    `gates` [L] the per-layer prompts and their injection gates (as the JAX
    package's `pipeline_tower` takes them): layer l adds gates[l] *
    prompts[l] at slots [token_offset, token_offset + P), then runs its
    block. -> [B, S, D], the tower's output, on every rank."""
    B = x.shape[0]
    prompts = prompts.expand((prompts.shape[0], B) + prompts.shape[2:])
    o = token_offset

    def body(l, mb, h):
        (prompt,) = mb
        P = prompt.shape[1]
        h = torch.cat([h[:, :o], h[:, o:o + P] + gates[l].to(h.dtype) * prompt.to(h.dtype),
                       h[:, o + P:]], dim=1)
        return blocks[l](h)

    return pipeline_scan(group, body, list(range(len(blocks))), x,
                         microbatches=microbatches, layered_mb=(prompts,),
                         data_group=data_group)
