"""Carry JAX (Flax) parameters into the PyTorch modules.

`params_from_jax(params)` maps the Flax params tree of
`lpi_tpu.models.glip.grounding.GroundedVLModel`, as numpy arrays, to a
`state_dict` of `lpi_tpu_torch.models.glip.grounding.GroundedVLModel`:

* each scanned `encoder/stage{s}` FusedPair carries a leading [n_pairs]
  axis; pair p's `vblock{j}` / `tlayer{j}` become the per-block modules
  `encoder.blocks.{i}` / `encoder.layers.{i}`, i = stage offset + 2p + j;
* Flax HWIO conv kernels become OIHW weights, Dense [in, out] kernels
  become Linear [out, in] weights;
* LayerNorm / GroupNorm `scale` becomes `weight`;
* the prompt and interaction pools and the head's scalars are copied as
  they are.

`keys_from_jax(centers, valid)` builds the port's `TaskKeys`. Nothing here
imports JAX: the caller hands over numpy arrays.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from lpi_tpu_torch.continual.keys import TaskKeys

_RENAMES = (
    (re.compile(r"^encoder/swin/downsample(\d+)/"), r"encoder/swin/downsamples/\1/"),
    (re.compile(r"^encoder/swin/out_norm(\d+)/"), r"encoder/swin/out_norms/\1/"),
    (re.compile(r"^fpn/(inner|layer)(\d+)_conv/"), r"fpn/\1/\2/"),
    (re.compile(r"^head/tower(\d+)/"), r"head/towers/\1/"),
)
_STAGE = re.compile(r"^encoder/stage(\d+)/(vblock|tlayer)(\d)/(.*)$")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _leaf(path: str, value: np.ndarray):
    """Flax leaf -> (torch dotted name, array in torch layout)."""
    head, _, name = path.rpartition("/")
    if name == "kernel" and value.ndim == 4:  # HWIO -> OIHW
        name, value = "weight", value.transpose(3, 2, 0, 1)
    elif name == "kernel" and value.ndim == 2:  # [in, out] -> [out, in]
        name, value = "weight", value.T
    elif name == "scale":
        name = "weight"
    return f"{head}/{name}".replace("/", "."), value


def params_from_jax(params: Mapping, depths: Sequence[int] = (2, 2, 6, 2)
                    ) -> Dict[str, torch.Tensor]:
    """Flax GroundedVLModel params (nested dict of arrays) -> state_dict.
    `depths` are the Swin stage depths of the config."""
    offsets = np.concatenate([[0], np.cumsum(depths)[:-1]])
    flat = {}
    for path, value in _flatten(params).items():
        m = _STAGE.match(path)
        if m:
            s, kind, j, rest = int(m[1]), m[2], int(m[3]), m[4]
            group = "blocks" if kind == "vblock" else "layers"
            for p in range(value.shape[0]):
                i = offsets[s] + 2 * p + j
                flat[f"encoder/{group}/{i}/{rest}"] = value[p]
            continue
        for pattern, repl in _RENAMES:
            path = pattern.sub(repl, path)
        flat[path] = value
    state = {}
    for path, value in flat.items():
        name, arr = _leaf(path, value)
        state[name] = torch.tensor(np.ascontiguousarray(arr), dtype=torch.float32)
    return state


def keys_from_jax(centers, valid) -> TaskKeys:
    """JAX TaskKeys fields (as numpy) -> the port's TaskKeys, on the CPU."""
    return TaskKeys(torch.from_numpy(np.asarray(centers, np.float32).copy()),
                    torch.from_numpy(np.asarray(valid, bool).copy()))
