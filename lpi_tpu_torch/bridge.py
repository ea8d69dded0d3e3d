"""Carry JAX (Flax) parameters into the PyTorch modules.

`params_from_jax(params)` maps the Flax params tree of
`lpi_tpu.models.glip.grounding.GroundedVLModel`, as numpy arrays, to a
`state_dict` of `lpi_tpu_torch.models.glip.grounding.GroundedVLModel`:

* each scanned `encoder/stage{s}` FusedPair carries a leading [n_pairs]
  axis; pair p's `vblock{j}` / `tlayer{j}` become the per-block modules
  `encoder.blocks.{i}` / `encoder.layers.{i}`, i = stage offset + 2p + j;
* Flax HWIO conv kernels become OIHW weights, Dense [in, out] kernels
  become Linear [out, in] weights;
* LayerNorm / GroupNorm `scale` becomes `weight`; the GroupNorm FPN's
  `{inner,layer}{i}_gn` (siblings of the convs in Flax, though built inside
  an `nn.Sequential`) become the `gn` of conv i;
* the head's `tower{i}`, `fuse{i}` (early fusion's VLFuse) and `lang{i}`
  (its BERT layers) become `towers.{i}`, `fuses.{i}` and `langs.{i}`;
* the prompt and interaction pools and the head's scalars (VLFuse's
  layer scales among them) are copied as they are.

`slinet_params_from_jax(params)` maps the Flax params tree of
`lpi_tpu.models.clip.SliNet` to a `state_dict` of
`lpi_tpu_torch.models.clip.SliNet`: each tower's scanned
`transformer/block` leaves carry a leading [layers] axis and become the
per-layer modules `transformer.{i}`; Dense kernels are transposed, the
patch stem `conv1` goes from HWIO to OIHW, LayerNorm `scale` becomes
`weight`; `proj` and `text_projection` stay [in, out] (the towers compute
`x @ proj`); the embeddings, `logit_scale`, the CP factors and `ctx_pool`
are copied.

`zoo_params_from_jax(params)` maps the Flax params tree of any module of
the detector zoo (`lpi_tpu.models.glip.{resnet,swin,swin_variants,
efficientnet,fbnet,fcos,retina,atss_head,roi_heads,roi_mask_keypoint}`) to
a `state_dict` of its port:

* `stage{s}_block{b}` become `blocks.{s}.{b}`; `downsample{s}`,
  `out_norm{s}`, `lateral{i}`, `bifpn{i}` and the heads' numbered convs
  (`cls_tower{i}`, `box_tower{i}`, `bbox_tower{i}`, `fcn{i}`,
  `conv_fcn{i}`) become list entries; BiFPN's `td{i}_dw` / `_pw` / `_bn`
  (and `bu{i}_...`) become `convs.td{i}.dw` ...;
* conv kernels HWIO -> OIHW (a depthwise kernel's I is 1, which is torch's
  [C, 1, kh, kw] for `groups=C`), Dense kernels transposed, frozen-BN and
  LayerNorm `scale` -> `weight`;
* the transposed convs (`deconv`, `kps_score_lowres`, Flax's
  `ConvTranspose`, which does not flip its kernel) are flipped in H and W
  and laid out [in, out, kh, kw] (`models/layers.py:ConvTranspose`);
* the Swin bias tables (`relative_position_bias_table`,
  `i2t_relative_position_bias`, `t2t_relative_position_bias`), BiFPN's
  fusion weights `w_td` / `w_bu` and the per-level `scales` are copied as
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
    (re.compile(r"^fpn/(inner|layer)(\d+)_gn/"), r"fpn/\1/\2/gn/"),
    (re.compile(r"^head/tower(\d+)/"), r"head/towers/\1/"),
    (re.compile(r"^head/fuse(\d+)/"), r"head/fuses/\1/"),
    (re.compile(r"^head/lang(\d+)/"), r"head/langs/\1/"),
)
_ZOO_RENAMES = (
    (re.compile(r"(^|/)stage(\d+)_block(\d+)/"), r"\1blocks/\2/\3/"),
    (re.compile(r"(^|/)(downsample|out_norm)(\d+)/"), r"\1\2s/\3/"),
    (re.compile(r"(^|/)(cls_tower|box_tower|bbox_tower|fcn|conv_fcn|lateral|bifpn)(\d+)/"),
     r"\1\2/\3/"),
    (re.compile(r"(^|/)(td|bu)(\d+)_(dw|pw|bn)/"), r"\1convs/\2\3/\4/"),
)
_TRANSPOSED = re.compile(r"(^|/)(deconv|kps_score_lowres)/kernel$")
_STAGE = re.compile(r"^encoder/stage(\d+)/(vblock|tlayer)(\d)/(.*)$")
_TOWER = re.compile(r"^(clip/(?:visual|text)/transformer)/block/(.*)$")


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
    return f"{head}/{name}".lstrip("/").replace("/", "."), value


def _to_state(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """{Flax leaf path: array} -> fp32 state_dict entries (`_leaf`)."""
    state = {}
    for path, value in flat.items():
        name, arr = _leaf(path, value)
        state[name] = torch.tensor(np.ascontiguousarray(arr), dtype=torch.float32)
    return state


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
    return _to_state(flat)


def slinet_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax SliNet params (nested dict of arrays) -> state_dict."""
    flat = {}
    for path, value in _flatten(params).items():
        m = _TOWER.match(path)
        if m:
            for i in range(value.shape[0]):
                flat[f"{m[1]}/{i}/{m[2]}"] = value[i]
        else:
            flat[path] = value
    return _to_state(flat)


def zoo_params_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params of a detector-zoo module (nested dict of arrays) ->
    state_dict of its port."""
    flat = {}
    for path, value in _flatten(params).items():
        if _TRANSPOSED.search(path):  # HWIO, unflipped -> [in, out, kh, kw], flipped
            path = path[:-len("kernel")] + "weight"
            value = value[::-1, ::-1].transpose(2, 3, 0, 1)
        for pattern, repl in _ZOO_RENAMES:
            path = pattern.sub(repl, path)
        flat[path] = value
    return _to_state(flat)


def keys_from_jax(centers, valid) -> TaskKeys:
    """JAX TaskKeys fields (as numpy) -> the port's TaskKeys, on the CPU."""
    return TaskKeys(torch.from_numpy(np.asarray(centers, np.float32).copy()),
                    torch.from_numpy(np.asarray(valid, bool).copy()))
