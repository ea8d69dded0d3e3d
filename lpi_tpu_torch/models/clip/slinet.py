"""SliNet: the prompted CLIP dual encoder with task-wise pools (counterpart
of `lpi_tpu/models/clip/slinet.py`).

A frozen CLIP ViT-B/16 plus a DecomposedPrompt pool (one CP-factorised
prompt stack per continual task, `prompt_type="lpi"`) and a CoOp context
pool (`ctx_pool`, one context per task, which the "lpi" forward never
reads but the optimizer still decays). Selecting a task is a gather on the
leading task axis; at evaluation each sample's prompts are gathered by its
inferred task id (`encode_image_tasks`, `encode_text_tasks`). The other
prompt types ("sprompts", "clip", "l2p", "maple") are not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from lpi_tpu_torch.config import RetrievalConfig
from lpi_tpu_torch.models.clip.model import CLIP
from lpi_tpu_torch.models.layers import lecun_normal_, normal_
from lpi_tpu_torch.prompts.pools import build_prompt_pool


class SliNet(nn.Module):
    """Prompted CLIP with task-indexed prompt and context pools."""

    def __init__(self, cfg: RetrievalConfig):
        super().__init__()
        self.cfg = cfg
        lpi = cfg.lpi
        if lpi.prompt_type != "lpi":
            raise NotImplementedError(
                f"prompt_type {lpi.prompt_type!r} is not ported yet (ROADMAP A2)")
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.clip = CLIP(cfg.clip, self.dtype)
        self.prompts = build_prompt_pool(lpi.prompt_type, cfg.total_sessions, lpi.prompt_depth,
                                         lpi.prompt_length, cfg.visual_dim, cfg.textual_dim,
                                         lpi.prompt_rank)
        self.ctx_pool = nn.Parameter(
            torch.zeros(cfg.total_sessions, cfg.clip.n_ctx, cfg.clip.text_width))

    # ---- prompt access -------------------------------------------------
    def task_prompts(self, task_id) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.prompts(task_id)

    def all_task_prompts(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.prompts.all_prompts()

    # ---- training forward ---------------------------------------------
    def forward(self, images: torch.Tensor, token_ids: torch.Tensor, task_id):
        """One session's train forward: (image features, text features,
        visual prompt [L, P, Dv], textual prompt [L, P, Dt], logit scale);
        the features L2-normalised, fp32. `task_id` is an int or a 0-d
        integer tensor on the model's device."""
        depth = self.cfg.lpi.injection_depth
        vis_p, txt_p = self.prompts(task_id)
        img = self.clip.encode_image(images, vis_p, depth)
        txt = self.clip.encode_text(token_ids, ctx=txt_p[0], prompt=txt_p,
                                    injection_depth=depth)
        return img, txt, vis_p, txt_p, self.logit_scale()

    # ---- evaluation: per-sample task selection ---------------------------
    def encode_image_tasks(self, images: torch.Tensor, task_ids: torch.Tensor) -> torch.Tensor:
        vis_b, _ = self.prompts.gather(task_ids)
        return self.clip.encode_image(images, vis_b, self.cfg.lpi.injection_depth)

    def encode_text_tasks(self, token_ids: torch.Tensor, task_ids: torch.Tensor) -> torch.Tensor:
        _, txt_b = self.prompts.gather(task_ids)
        return self.clip.encode_text(token_ids, ctx=txt_b[:, 0], prompt=txt_b,
                                     injection_depth=self.cfg.lpi.injection_depth)

    # ---- frozen-backbone features (task keys) ----------------------------
    def extract_visual(self, images: torch.Tensor) -> torch.Tensor:
        return self.clip.encode_image(images)

    def extract_textual(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.clip.encode_text(token_ids)

    def logit_scale(self) -> torch.Tensor:
        return self.clip.logit_scale.exp()


@torch.no_grad()
def init_parameters(model: SliNet, generator: torch.Generator) -> None:
    """Seeded random parameters with the JAX package's initialisers: Dense
    kernels and the patch stem lecun-normal, biases zero, LayerNorms
    one/zero; the vision tower's class and position embeddings and `proj`
    N(0, width^-1); the text positions N(0, 0.01^2), `text_projection`
    N(0, text_width^-1), the token embedding N(0, 0.02^2); the logit scale
    `logit_scale_init`; the prompt factors N(0, 0.5^2), `ctx_pool`
    N(0, 0.02^2)."""
    c = model.cfg.clip
    stds = {"clip.visual.class_embedding": c.vision_width ** -0.5,
            "clip.visual.positional_embedding": c.vision_width ** -0.5,
            "clip.visual.proj": c.vision_width ** -0.5,
            "clip.text.positional_embedding": 0.01,
            "clip.text.text_projection": c.text_width ** -0.5,
            "clip.token_embedding": 0.02, "ctx_pool": 0.02}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name in stds:
            normal_(p, stds[name], generator)
        elif name.startswith("prompts."):
            normal_(p, 0.5, generator)
        elif name == "clip.logit_scale":
            p.fill_(float(c.logit_scale_init))
        elif leaf == "weight" and p.dim() >= 2:
            lecun_normal_(p, generator)
        elif leaf == "weight":  # LayerNorm scales
            p.fill_(1.0)
        else:
            p.zero_()
