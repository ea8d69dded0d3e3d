"""Multi-process helpers over `torch.distributed` (counterpart of
`lpi_tpu/core/dist.py`).

The host-side surface of the reference's `utils/comm.py`, as the JAX
package keeps it: rank queries, a barrier, a pickled-object gather and a
dict reduction, each short-circuiting in a single process
(`torch.distributed` not started). Besides:

* `init_from_env(platform)` starts the process group from torchrun's
  `RANK`, `WORLD_SIZE` and `LOCAL_RANK`: NCCL with one rank per card
  (`cuda:LOCAL_RANK`), or gloo on the CPU for `platform="cpu"`. A failure
  to start raises: nothing carries on with another backend or one process.
* The in-step collectives, written so that a CUDA graph can capture them
  (no host read-back) and so that they work on any subgroup, which
  `torch.distributed.nn.functional.all_gather`'s backward does not (it
  asks the world group for the rank):
  - `gather_rows(x, group)`: every rank's rows, in rank order; backward,
    the sum of every rank's gradient of the gathered rows, then this
    rank's rows. The gradient that reaches rank r's `x` is that of the sum
    of every rank's loss;
  - `global_mean(x, group)`: the mean over the group; backward, the
    gradient as it is (this rank's own loss's). With it a step reports the
    batch-wide value while each rank differentiates its own share;
  - `all_sum(x, group)`: a sum over the group with no gradient (the
    batch-wide loss normalisers);
  - `average_gradients(grads, group)`: the mean over the group of a list
    of gradients (None passing through), one collective a dtype;
  - `copy_to(x, group)` and `reduce_from(x, group)`: Megatron's f and g
    of a tensor-parallel block (identity forward and a sum backward; a sum
    forward and identity backward).

Every rank must call a collective in the same order; the data-parallel
convention is DDP's: each rank's loss is the mean over its rows, and the
gradients are averaged over the `data` group, which gives the gradient of
the global batch's loss.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def started() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if started() else 1


def get_rank() -> int:
    return dist.get_rank() if started() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def synchronize() -> None:
    """Barrier across processes (nothing in a single process)."""
    if get_world_size() > 1:
        dist.barrier()


def all_gather_objects(obj: Any) -> List[Any]:
    """One picklable object per process -> the list, ordered by rank."""
    if get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _backend_device() -> torch.device:
    """Where the default group's collectives take their tensors."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_dict(metrics: Dict[str, float], average: bool = True) -> Dict[str, float]:
    """Average (or sum) scalar metrics across processes."""
    world = get_world_size()
    if world == 1:
        return dict(metrics)
    keys = sorted(metrics)
    values = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64,
                          device=_backend_device())
    dist.all_reduce(values)
    if average:
        values /= world
    return {k: float(v) for k, v in zip(keys, values.tolist())}


def init_from_env(platform: str = "gpu", init_method: str = "env://") -> torch.device:
    """Start the default process group from torchrun's environment (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`; with "env://", `MASTER_ADDR` and
    `MASTER_PORT` too). On the card ("gpu") this rank takes
    `cuda:LOCAL_RANK` and starts NCCL there, its communicator made at once;
    "cpu" starts gloo. One collective checks the group before anything else
    runs. -> this rank's device."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    if platform == "cpu":
        device = torch.device("cpu")
        dist.init_process_group("gloo", init_method=init_method, rank=rank,
                                world_size=world)
    elif platform == "gpu":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: NCCL needs one card a rank; pass --platform "
                               "cpu for gloo on the CPU")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} but {torch.cuda.device_count()} card(s)")
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=init_method, rank=rank,
                                world_size=world, device_id=device)
    else:
        raise ValueError(f"unknown platform {platform!r}")
    check = torch.ones(1, device=device)
    dist.all_reduce(check)
    if int(check.item()) != world:
        raise RuntimeError(f"the process group's first sum gave {check.item()}, want {world}")
    return device


# ---- collectives inside a step --------------------------------------------
class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        r, n = dist.get_rank(ctx.group), ctx.rows
        return grad[r * n:(r + 1) * n], None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] on each of the group's k ranks -> [k n, ...], rank order.
    Backward: the gathered gradient summed over the group, this rank's rows
    taken."""
    return _GatherRows.apply(x, group)


class _GlobalMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of `x` over the group; its gradient passes to this rank's
    `x` as it is (DDP's convention: each rank differentiates its own loss,
    and `average_gradients` makes the mean)."""
    return _GlobalMean.apply(x, group)


@torch.no_grad()
def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group, no gradient."""
    out = x.detach().clone()
    dist.all_reduce(out, group=group)
    return out


@torch.no_grad()
def average_gradients(grads: Sequence[Optional[torch.Tensor]],
                      group) -> List[Optional[torch.Tensor]]:
    """The mean over the group of each gradient, through one flat buffer
    per dtype (one collective each); a None (a leaf that no rank's loss
    reads) stays None. Over one rank the values are those given, bit for
    bit."""
    n = dist.get_world_size(group)
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    for dtype in sorted({g.dtype for g in grads if g is not None}, key=str):
        idx = [i for i, g in enumerate(grads) if g is not None and g.dtype == dtype]
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        flat /= n
        for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
            out[i] = part.view_as(grads[i])
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: `x` as it is; backward, the gradient summed over the
    group (each rank's shard of the block contributes its part)."""
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum of the ranks' partial outputs; backward, the
    gradient as it is."""
    return _ReduceFrom.apply(x, group)
