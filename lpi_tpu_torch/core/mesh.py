"""The (data, model) grid of ranks and its layouts (counterpart of
`lpi_tpu/core/mesh.py`).

The JAX package builds one `jax.sharding.Mesh` and lets XLA insert the
collectives. Here the mesh is the process group of `torch.distributed`,
one rank per card (NCCL) or per CPU process (gloo), arranged as a
`DeviceMesh` with the axes ("data", "model"), rank = d * mp + m as the
JAX package's `reshape(dp, mp)`:

* `data` shards the batch: every rank builds the same global batch from
  the same seed and takes its rows (`shard_batch`); the learners sum every
  batch-wide normaliser and average every gradient over the `data` group;
* `model` carries Megatron tensor parallelism of the tower weights
  (`shard_params`), with the JAX package's rules (`_TP_COLUMN`,
  `_TP_ROW`, `_TP_SCOPED`) applied to the port's parameter names;
* parameters are seeded alike on every rank and then broadcast from rank
  0 (`replicate`), so every rank starts from rank 0's values.

The port's `Dense` weight is [out, in], the transpose of a Flax kernel: a
column-parallel layer shards dim 0 of its weight (and its bias), a
row-parallel one dim 1 (its bias stays whole and is added once, after the
sum over `model`). The packed QKV projections of CLIP and Swin stay
replicated, as does any layer whose sharded dimension does not divide by
mp. A mesh must hold every rank of the group: more ranks than dp x mp
raise here (the JAX package leaves spare devices idle), as do fewer.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from lpi_tpu_torch.config import MeshConfig
from lpi_tpu_torch.core import dist as dist_lib
from lpi_tpu_torch.models.layers import Dense, _compute_dtype


def mesh_shape(cfg: MeshConfig, world: int) -> Tuple[int, int]:
    """(dp, mp) of `cfg` over `world` ranks; dp = -1 takes every rank
    divided by mp."""
    mp = max(1, cfg.model_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else world // mp
    if dp * mp > world:
        raise ValueError(f"mesh {dp}x{mp} needs {dp * mp} devices, have {world}")
    if dp * mp < world:
        raise ValueError(f"mesh {dp}x{mp} leaves {world - dp * mp} of {world} ranks out: "
                         f"every rank of the group must hold a place in the mesh")
    return dp, mp


class Mesh:
    """A `DeviceMesh` of the group with axes (data, model), its two
    subgroups, this rank's coordinates and its device."""

    def __init__(self, device_mesh, data_axis: str = "data", model_axis: str = "model"):
        self.device_mesh = device_mesh
        self.dp, self.mp = device_mesh.shape
        self.data_group = device_mesh.get_group(data_axis)
        self.model_group = device_mesh.get_group(model_axis)
        self.data_rank = device_mesh.get_local_rank(data_axis)
        self.model_rank = device_mesh.get_local_rank(model_axis)
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if device_mesh.device_type == "cuda" else torch.device("cpu"))

    def __repr__(self) -> str:
        return (f"Mesh({self.dp}x{self.mp}, rank {dist.get_rank()} at "
                f"({self.data_rank}, {self.model_rank}), {self.device})")


def make_mesh(cfg: MeshConfig = MeshConfig()) -> Mesh:
    """The (data, model) mesh over every rank of the started group (NCCL:
    the card's; gloo: the CPU's). Each subgroup runs one collective here,
    eagerly, so that its communicator exists before any step is captured."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist_lib.started():
        raise RuntimeError("make_mesh needs a started process group "
                           "(lpi_tpu_torch.core.dist.init_from_env)")
    dp, mp = mesh_shape(cfg, dist.get_world_size())
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (dp, mp), mesh_dim_names=(cfg.data_axis, cfg.model_axis))
    mesh = Mesh(dm, cfg.data_axis, cfg.model_axis)
    rank = dist.get_rank()
    if (mesh.data_rank, mesh.model_rank) != (rank // mp, rank % mp):
        raise RuntimeError(f"rank {rank} sits at {(mesh.data_rank, mesh.model_rank)} of the "
                           f"device mesh, want {(rank // mp, rank % mp)}")
    for group in (mesh.data_group, mesh.model_group):
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=group)
    return mesh


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    if global_batch % mesh.dp != 0:
        raise ValueError(f"global batch {global_batch} not divisible by data-parallel "
                         f"{mesh.dp}")
    return global_batch // mesh.dp


def shard_rows(x, mesh: Mesh):
    """This rank's rows of a global array or tensor (batch axis first)."""
    n = local_batch_size(x.shape[0], mesh)
    return x[mesh.data_rank * n:(mesh.data_rank + 1) * n]


def shard_batch(mesh: Optional[Mesh], batch: Mapping) -> Mapping:
    """This rank's rows of every entry of a global batch (numpy arrays or
    tensors, batch axis first); the batch itself without a mesh."""
    return batch if mesh is None else {k: shard_rows(v, mesh) for k, v in batch.items()}


def over_rows(mesh: Optional[Mesh], x, fn):
    """`fn` (row-wise, no gradient) over this rank's rows of `x` (a tensor
    or a mapping of them, rows first), its outputs (a tensor, or a tuple
    or a mapping of them, rows first) gathered over `data`, when the rows
    divide over it; else `fn(x)`, as the JAX learners shard only a batch
    that divides."""
    rows = (next(iter(x.values())) if isinstance(x, Mapping) else x).shape[0]
    if mesh is None or mesh.dp <= 1 or rows % mesh.dp:
        return fn(x)
    out = fn(shard_batch(mesh, x) if isinstance(x, Mapping) else shard_rows(x, mesh))

    def gather(t):
        return dist_lib.gather_rows(t, mesh.data_group)

    if isinstance(out, Mapping):
        return {k: gather(v) for k, v in out.items()}
    return tuple(map(gather, out)) if isinstance(out, tuple) else gather(out)


@torch.no_grad()
def replicate(tensors) -> None:
    """Every tensor broadcast from rank 0 of the group, in place."""
    for t in tensors:
        dist.broadcast(t.data, src=0)


# ---------------------------------------------------------------------------
# tensor parallelism (Megatron) over the mesh's `model` axis
# ---------------------------------------------------------------------------
# The JAX package's rules (`lpi_tpu/core/mesh.py:111-113`): column-parallel
# modules shard their output features (kernel and bias), row-parallel ones
# their input features (kernel; the bias stays whole). A scoped name only
# counts under its scope: "tlayer" (the fused encoder's BERT layers, the
# port's `encoder.layers.{i}`) and "mlp" (Swin's MLP).
_TP_COLUMN = ("mlp_c_fc", "fc1", "intermediate", "query", "key", "value")
_TP_ROW = ("mlp_c_proj", "fc2", "output", "attention_output")
_TP_SCOPED = {"output": "tlayer", "intermediate": "tlayer",
              "query": "tlayer", "key": "tlayer", "value": "tlayer",
              "fc1": "mlp", "fc2": "mlp"}


def _in_scope(scope: str, parents) -> bool:
    if scope == "tlayer":
        return tuple(parents[:2]) == ("encoder", "layers")
    return any(scope in p for p in parents)


def tp_dim(name: str, shape, mp: int) -> Optional[int]:
    """The dim of the port's parameter `name` (of `shape`) that tensor
    parallelism over `mp` ranks shards, or None (replicated): dim 0 of a
    column-parallel weight and its bias, dim 1 of a row-parallel weight."""
    parts = name.split(".")
    if mp <= 1 or len(parts) < 2:
        return None
    module, leaf = parts[-2], parts[-1]
    scope = _TP_SCOPED.get(module)
    if scope is not None and not _in_scope(scope, parts[:-2]):
        return None
    if module in _TP_COLUMN and leaf in ("weight", "bias"):
        dim = 0
    elif module in _TP_ROW and leaf == "weight" and len(shape) == 2:
        dim = 1
    else:
        return None
    return dim if shape[dim] % mp == 0 else None


def tp_param_shardings(model: nn.Module, mp: int) -> Dict[str, Optional[int]]:
    """{parameter name: the sharded dim or None} of `model` under `mp`-way
    tensor parallelism (the counterpart of the JAX package's
    NamedSharding tree, in the port's [out, in] layout)."""
    return {n: tp_dim(n, tuple(p.shape), mp) for n, p in model.named_parameters()}


class ColumnParallelDense(Dense):
    """A `Dense` holding rows [r k, (r+1) k) of its weight and bias: its
    input whole on every rank of the group, its output this rank's k
    features."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(dist_lib.copy_to(x, self.tp_group))


class RowParallelDense(Dense):
    """A `Dense` holding columns [r k, (r+1) k) of its weight: its input
    this rank's k features (`tp_input_sharded`, after a column-parallel
    layer) or whole (then sliced here), its partial outputs summed over
    the group, then the whole bias added once."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.tp_input_sharded:
            k = self.weight.shape[1]
            x = dist_lib.copy_to(x, self.tp_group)[..., self.tp_rank * k:(self.tp_rank + 1) * k]
        cd = _compute_dtype(x, self.weight, self.compute_dtype)
        y = dist_lib.reduce_from(F.linear(x.to(cd), self.weight.to(cd)), self.tp_group)
        return y if self.bias is None else y + self.bias.to(cd)


# row-parallel module -> the column-parallel sibling that feeds it
_FED_BY = {"mlp_c_proj": "mlp_c_fc", "fc2": "fc1", "output": "intermediate"}


@torch.no_grad()
def shard_params(mesh: Mesh, model: nn.Module) -> Dict[str, Optional[int]]:
    """Megatron layouts over the mesh's `model` axis, in place: each
    column- or row-parallel `Dense` keeps this rank's shard of its weight
    (and a column layer's bias) and becomes a `ColumnParallelDense` or
    `RowParallelDense`; a BERT attention whose q/k/v are sharded keeps
    heads / mp heads. Nothing changes when mp is 1. -> the layout."""
    mp, r = mesh.mp, mesh.model_rank
    layout = tp_param_shardings(model, mp)
    if mp <= 1:
        return layout
    modules = dict(model.named_modules())
    sharded = {n.rpartition(".")[0] for n, d in layout.items() if d is not None}
    for mname in sorted(sharded):
        mod = modules[mname]
        if not isinstance(mod, Dense):
            raise TypeError(f"{mname}: tensor parallelism shards Dense layers, not "
                            f"{type(mod).__name__}")
        dim = layout[f"{mname}.weight"]
        k = mod.weight.shape[dim] // mp
        mod.weight = nn.Parameter(mod.weight.narrow(dim, r * k, k).clone(),
                                  requires_grad=mod.weight.requires_grad)
        if dim == 0:
            if mod.bias is not None:
                mod.bias = nn.Parameter(mod.bias.narrow(0, r * k, k).clone(),
                                        requires_grad=mod.bias.requires_grad)
            mod.__class__ = ColumnParallelDense
        else:
            parent, _, leaf = mname.rpartition(".")
            if leaf == "attention_output":
                feeder = f"{parent}.attention.query"
            else:
                feeder = f"{parent}.{_FED_BY.get(leaf, '')}"
            mod.tp_input_sharded = feeder in sharded
            mod.__class__ = RowParallelDense
        mod.tp_group, mod.tp_rank = mesh.model_group, r
    for mname, mod in modules.items():
        q = f"{mname}.query"
        if q in sharded:
            if not all(f"{mname}.{x}" in sharded for x in ("key", "value")):
                raise ValueError(f"{mname}: query, key and value must shard together")
            if mod.num_heads % mp:
                raise ValueError(f"{mname}: {mod.num_heads} heads do not divide over "
                                 f"{mp} ranks of the model axis")
            mod.num_heads //= mp
    return layout


@torch.no_grad()
def gather_params(mesh: Optional[Mesh], params: Mapping[str, torch.Tensor],
                  layout: Mapping[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """Whole parameters from their tensor-parallel shards (the shards
    gathered over `model` along their dim): what a checkpoint saves."""
    out = {}
    for name, p in params.items():
        dim = layout.get(name)
        if mesh is None or mesh.mp <= 1 or dim is None:
            out[name] = p
            continue
        parts = [torch.empty_like(p) for _ in range(mesh.mp)]
        dist.all_gather(parts, p.detach().contiguous(), group=mesh.model_group)
        out[name] = torch.cat(parts, dim=dim)
    return out

