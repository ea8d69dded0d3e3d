"""Typed configuration tree for the whole framework.

Replaces the reference's two config systems — the flat argparse/JSON dict of
the retrieval half (`retrieval/main.py:18-20`) and the yacs CfgNode tree of
the grounding half (`grounding/maskrcnn_benchmark/config/defaults.py`) —
with a single dataclass tree. The `LPIPromptConfig` section mirrors the reference's
`MODEL.LPAI` keys (`defaults.py:844-860`).

Configs are plain frozen dataclasses so they are hashable. This is the
PyTorch package's own copy of `lpi_tpu/core/config.py`: the same dataclasses,
defaults and `load_config` JSON layout, with no import of the JAX package
(whose `core/__init__.py` pulls in the mesh and pipeline code).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence


def _freeze(seq):
    return tuple(seq)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout (`core.mesh.make_mesh`): the ranks of the process
    group as one mesh with named axes; collectives ride NCCL (gloo on the
    CPU).

    `data` shards the batch; `model` carries the tensor-parallel layouts of
    the towers (unused by parity configs).
    """

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1 = all available devices
    model_parallel: int = 1


@dataclass(frozen=True)
class LPIPromptConfig:
    """The LPI mechanism knobs (reference `MODEL.LPAI`, defaults.py:844-860)."""

    prompt_type: str = "lpi"  # lpi | sprompts | l2p | maple
    prompt_length: int = 16  # tokens per prompt (PROMPT_LENGTH)
    prompt_depth: int = 9  # layers that receive prompts (PROMPT_DEPTH)
    prompt_rank: int = 4  # CP rank of DecomposedPrompt (PROMPT_LORA_D)
    interact: bool = True  # cross-modal interaction net (INTERACT)
    interact_rank: int = 4  # CP rank of InteractModule (INTERACT_LORA_D)
    interact_depth: int = 9  # layers that run interaction (INTERACT_DEPTH)
    interact_type: str = "linear"  # linear | maple | l2p | dcp
    task_alignment: bool = True  # inter-task contrastive loss (TASK_ALIGNMENT)
    layer_alignment: bool = True  # cross-modal alignment loss (LAYER_ALIGNMENT)
    alignment_weight: float = 0.1  # slinet.py:158
    task_loss_weight: float = 0.1  # slinet.py:161
    alignment_temperature: float = 0.01  # slinet.py:145
    task_temperature: float = 0.001  # slinet.py:182
    task_sim_threshold: float = 0.4  # slinet.py:173
    # Depth of per-layer injection actually applied. The reference's deep
    # injection is dead code in the retrieval half (clip/model.py:190 gate is
    # always false); depth=1 reproduces that input-only behavior.
    injection_depth: int = 1
    # L2P baseline pool geometry (`slinet.py:42`, L2pPrompt(length=4, top_k=4))
    l2p_length: int = 4
    l2p_top_k: int = 4


@dataclass(frozen=True)
class CLIPConfig:
    """CLIP ViT-B/16 dual encoder (reference vendored OpenAI CLIP)."""

    image_resolution: int = 224
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    vocab_size: int = 49408
    context_length: int = 77
    embed_dim: int = 512
    n_ctx: int = 16  # CoOp context length (cfgc.NCTX, prompt_learner.py:224)
    class_token_position: str = "end"
    logit_scale_init: float = 4.6052  # ln(100), OpenAI CLIP init
    # 'bf16' (default) = hand-rolled attention keeping the [B,H,S,S] score
    # and probability tensors in the compute dtype (identical math to 'xla'
    # under a fp32 model dtype); 'xla' = the framework's fused attention
    attn_impl: str = "bf16"
    # tower-block remat policy of the JAX train step: 'none', 'dots_nb' or
    # 'dots' (the JAX package documents its measurements)
    remat: str = "none"
    # scan unroll factor of the JAX tower scans (>= layers = fully unrolled)
    tower_unroll: int = 12


@dataclass(frozen=True)
class RetrievalConfig:
    """Continual retrieval run (reference `retrieval/configs/lpi/coco_lpi.json`)."""

    clip: CLIPConfig = field(default_factory=CLIPConfig)
    lpi: LPIPromptConfig = field(default_factory=LPIPromptConfig)
    total_sessions: int = 12
    epochs: int = 10
    batch_size: int = 64
    lr: float = 0.05
    weight_decay: float = 2e-4
    momentum: float = 0.9
    seed: int = 1993
    num_key_clusters: int = 5  # KMeans k per task (sprompt.py:370)
    eval_text_chunk: int = 256
    visual_dim: int = 768
    textual_dim: int = 512
    # Hardcoded 12-session category order, retrieval/utils/data.py:327-343.
    task_order: Sequence[int] = (11, 6, 3, 10, 5, 12, 7, 9, 2, 8, 4, 1)
    dtype: str = "bfloat16"  # compute dtype; params stay fp32


@dataclass(frozen=True)
class SwinConfig:
    """Swin-T (GLIP visual tower)."""

    patch_size: int = 4
    embed_dim: int = 96
    depths: Sequence[int] = (2, 2, 6, 2)
    num_heads: Sequence[int] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    ape: bool = False
    drop_path_rate: float = 0.2
    out_stages: Sequence[int] = (2, 3, 4)  # feed FPN


@dataclass(frozen=True)
class BertConfig:
    """BERT-base (GLIP language tower)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    max_query_len: int = 256  # MODEL.LANGUAGE_BACKBONE.MAX_QUERY_LEN
    num_pooled_layers: int = 1  # N_LAYERS mean-pooled into aggregate


@dataclass(frozen=True)
class DyHeadConfig:
    """VLDyHead (GLIP detection head)."""

    num_convs: int = 6
    channels: int = 256
    # MODEL.DYHEAD.NUM_CLASSES (incl. background, `defaults.py:425`); the
    # cls_logits conv emits num_classes-1 channels — dead under the
    # dot-product token loss (frozen, `generalized_vl_rcnn.py:152-156`) but
    # present in GLIP checkpoints
    num_classes: int = 81
    use_dyrelu: bool = True
    use_dyfuse: bool = True
    use_dfconv: bool = True
    # deformable-conv implementation: "fast", "fast_scan" and "pallas" are
    # the same matmul-first windowed math (offsets clamped to
    # +-deform_window px; the port runs all three through its CUDA window
    # kernels), "fused" samples first, "exact" is the bilinear-gather
    # reference semantics
    deform_impl: str = "pallas"
    deform_window: int = 3
    # product-map dtype of the windowed deform conv: "bfloat16", "float32",
    # or "auto" (default) = follow the model dtype, so a float32 config never
    # silently runs its deform convs in bf16 (that once cost the fp32
    # accuracy gate its task-ID accuracy)
    deform_dtype: str = "auto"
    # remat of the deform product map in the JAX train step: "on", "off",
    # or "auto" (save it only when this conv's map is < 128 MB)
    deform_remat: str = "auto"
    log_scale: float = 0.0
    prior_prob: float = 0.01
    early_fuse: bool = False  # EARLY_FUSE_ON: False in LPI configs
    fuse_embed_dim: int = 2048  # FUSE_CONFIG.EMBED_DIM
    fuse_heads: int = 8
    add_linear_layer: bool = True  # tunable_linear, language_prompt_v4
    max_tokens: int = 256


@dataclass(frozen=True)
class ATSSConfig:
    """ATSS matcher + losses (reference rpn/loss.py:518)."""

    topk: int = 9
    anchor_sizes: Sequence[int] = (64, 128, 256, 512, 1024)
    anchor_strides: Sequence[int] = (8, 16, 32, 64, 128)
    aspect_ratios: Sequence[float] = (1.0,)
    scales_per_octave: int = 1
    octave: float = 2.0
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    reg_loss_weight: float = 2.0
    pre_nms_top_n: int = 1000
    nms_thresh: float = 0.6
    fpn_post_nms_top_n: int = 100
    inference_thresh: float = 0.05


@dataclass(frozen=True)
class KnowledgeConfig:
    """GLIP-KNOW knowledge prompts (reference `defaults.py:872-879`,
    GLIPKNOW.*; off in every LPI config)."""

    knowledge_file: str = ""  # KNOWLEDGE_FILE
    knowledge_type: str = ""  # KNOWLEDGE_TYPE: "" | def_wiki | gpt3 | ...
    max_classes_per_batch: int = -1  # MAX_NUM_CLASSES_PER_BATCH_TRAIN
    parallel_language_input: bool = False  # PARALLEL_LANGUAGE_INPUT
    lan_feature_agg_type: str = "first"  # LAN_FEATURE_AGG_TYPE: first | mean
    gpt3_num: int = 5  # GPT3_NUM
    wiki_and_gpt3: bool = False  # WIKI_AND_GPT3


@dataclass(frozen=True)
class GroundingConfig:
    """Continual grounding run (reference finetune_A_decompose_interact_layer_task.yaml)."""

    swin: SwinConfig = field(default_factory=SwinConfig)
    bert: BertConfig = field(default_factory=BertConfig)
    dyhead: DyHeadConfig = field(default_factory=DyHeadConfig)
    atss: ATSSConfig = field(default_factory=ATSSConfig)
    lpi: LPIPromptConfig = field(default_factory=lambda: LPIPromptConfig(prompt_depth=9, interact_depth=9))
    total_tasks: int = 12
    epochs_per_task: int = 5  # LPAI.EPOCH
    # MODEL.FPN.USE_GN — default False in the reference (`defaults.py:277`;
    # the LPI yaml's USE_GN True is DYHEAD's); True adds the GN-conv variant
    fpn_use_gn: bool = False
    batch_size: int = 16  # IMS_PER_BATCH
    lr: float = 0.01
    weight_decay: float = 0.05
    grad_clip: float = 1.0
    seed: int = 0
    num_key_clusters: int = 5
    proposal_loss_weight: float = 0.8  # generalized_vl_rcnn.py:400-433
    # the reference's ACTUAL train/eval resolution: build_transforms
    # hardcodes Resize(448, 448, restrict=True) (`data/transforms/build.py:
    # 36-41`), overriding the yaml's 800/1333 (see data/transforms.py)
    image_size: int = 448
    # the JAX FusedDualEncoder's scan unroll factor (1 = scanned lockstep
    # body, 99 = fully unrolled); the port's schedule is a plain loop
    fused_scan_unroll: int = 1
    max_boxes: int = 100  # static padding of per-image GT boxes
    dtype: str = "bfloat16"
    knowledge: KnowledgeConfig = field(default_factory=KnowledgeConfig)


@dataclass(frozen=True)
class Config:
    """Root config: one of the two halves is active per run."""

    task: str = "retrieval"  # retrieval | grounding
    mesh: MeshConfig = field(default_factory=MeshConfig)
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)
    grounding: GroundingConfig = field(default_factory=GroundingConfig)
    output_dir: str = "res"
    checkpoint_dir: str = "checkpoints"


def _update_dataclass(obj: Any, updates: Mapping[str, Any]) -> Any:
    """Recursively apply a nested mapping of overrides to a dataclass tree."""
    kwargs = {}
    names = {f.name: f for f in dataclasses.fields(obj)}
    for key, value in updates.items():
        if key not in names:
            raise KeyError(f"unknown config key {key!r} for {type(obj).__name__}")
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            kwargs[key] = _update_dataclass(current, value)
        elif isinstance(current, tuple) and isinstance(value, (list, tuple)):
            kwargs[key] = _freeze(value)
        else:
            kwargs[key] = value
    return dataclasses.replace(obj, **kwargs)


def load_config(path: str | None = None, overrides: Mapping[str, Any] | None = None) -> Config:
    """Build a Config from an optional JSON file plus nested overrides.

    The JSON layout is the nested dataclass layout (e.g.
    `{"retrieval": {"epochs": 1}}`), replacing both the reference's flat JSON
    and its yacs YAML trees.
    """
    cfg = Config()
    if path is not None:
        with open(path) as f:
            cfg = _update_dataclass(cfg, json.load(f))
    if overrides:
        cfg = _update_dataclass(cfg, overrides)
    return cfg


def to_dict(cfg: Any) -> dict:
    return dataclasses.asdict(cfg)
