"""Frozen copy of the port's `lpi_tpu_torch/models/clip/slinet.py` for the
benchmark's reference. SliNet: the prompted CLIP dual encoder with task-wise
pools.

A frozen CLIP ViT-B/16, a prompt pool chosen by `prompt_type`, and a CoOp
context pool (`ctx_pool`, one context per task):

* "lpi": a DecomposedPrompt pool, one CP-factorised prompt stack per
  continual task; layer 0's visual prompt is concatenated after CLS, the
  textual prompt replaces the context slots;
* "sprompts": dense per-task prompts of one layer, injected as "lpi"'s;
* "l2p": one shared pool with keys (`L2pPrompt`) whose chosen prompts
  overwrite the leading image tokens between the patch stem and the
  tower; the text reads the task's `ctx_pool` entry;
* "clip": zero-shot CLIP, no pool; evaluation uses the frozen features.

Selecting a task is a gather on the leading task axis; at evaluation each
sample's prompts are gathered by its inferred task id (`encode_image_tasks`,
`encode_text_tasks`). The reference has no such path for "l2p" (its
`L2pPrompt` has no `all_prompts`), so both raise there. "lpi" and
"sprompts" never read `ctx_pool`; the optimizer still decays it.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from benchmark.reference.clip.model import CLIP
from benchmark.reference.layers import lecun_normal_, normal_
from benchmark.reference.pools import L2pPrompt, build_prompt_pool, task_row

L2P_EVAL_GAP = ("prompt_type 'l2p' has no evaluation path: the reference's L2pPrompt has no "
                "all_prompts, so its evaluate stops here too (ROADMAP C, a fault of lpi_tpu)")


class SliNet(nn.Module):
    """Prompted CLIP with task-indexed prompt and context pools."""

    def __init__(self, cfg: RetrievalConfig):
        super().__init__()
        self.cfg = cfg
        lpi = cfg.lpi
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        self.clip = CLIP(cfg.clip, self.dtype)
        # "clip" has no pool; the L2P pool lives at the vision width, as the
        # JAX package builds it (the reference's embed_dim=96 does not fit
        # its own ViT)
        self.prompts = None if lpi.prompt_type == "clip" else build_prompt_pool(
            lpi.prompt_type, cfg.total_sessions, lpi.prompt_depth, lpi.prompt_length,
            cfg.visual_dim, cfg.textual_dim, lpi.prompt_rank, l2p_length=lpi.l2p_length,
            l2p_top_k=lpi.l2p_top_k)
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
        the features L2-normalised, fp32. "clip" and "l2p" return zero
        prompts [1, 1, D] in their place. `task_id` is an int or a 0-d
        integer tensor on the model's device."""
        kind = self.cfg.lpi.prompt_type
        if kind in ("clip", "l2p"):
            if kind == "clip":
                img, txt = self.clip.encode_image(images), self.clip.encode_text(token_ids)
            else:
                img = self.encode_image_l2p(images)
                txt = self.clip.encode_text(token_ids, ctx=task_row(self.ctx_pool, task_id))
            zeros = [torch.zeros(1, 1, d, device=images.device)
                     for d in (self.cfg.visual_dim, self.cfg.textual_dim)]
            return img, txt, zeros[0], zeros[1], self.logit_scale()
        depth = self.cfg.lpi.injection_depth
        vis_p, txt_p = self.prompts(task_id)
        img = self.clip.encode_image(images, vis_p, depth)
        txt = self.clip.encode_text(token_ids, ctx=txt_p[0], prompt=txt_p,
                                    injection_depth=depth)
        return img, txt, vis_p, txt_p, self.logit_scale()

    def encode_image_l2p(self, images: torch.Tensor) -> torch.Tensor:
        """The L2P image path: the pool's chosen prompts overwrite the
        leading tokens between the patch stem and the tower; -> L2-normalised
        features (the pool's `reduce_sim` is dropped, as in the JAX
        package)."""
        x = self.prompts(self.clip.visual.embed(images))["prompted_embedding"]
        feats = self.clip.visual.encode(x)
        return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)

    # ---- evaluation: per-sample task selection ---------------------------
    def _eval_pool(self):
        if isinstance(self.prompts, L2pPrompt):
            raise NotImplementedError(L2P_EVAL_GAP)
        return self.prompts

    def encode_image_tasks(self, images: torch.Tensor, task_ids: torch.Tensor) -> torch.Tensor:
        vis_b, _ = self._eval_pool().gather(task_ids)
        return self.clip.encode_image(images, vis_b, self.cfg.lpi.injection_depth)

    def encode_text_tasks(self, token_ids: torch.Tensor, task_ids: torch.Tensor) -> torch.Tensor:
        _, txt_b = self._eval_pool().gather(task_ids)
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
    `logit_scale_init`; the prompt pool's leaves as its `init_leaf_` draws
    them; `ctx_pool` N(0, 0.02^2)."""
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
            model.prompts.init_leaf_(leaf, p, generator)
        elif name == "clip.logit_scale":
            p.fill_(float(c.logit_scale_init))
        elif leaf == "weight" and p.dim() >= 2:
            lecun_normal_(p, generator)
        elif leaf == "weight":  # LayerNorm scales
            p.fill_(1.0)
        else:
            p.zero_()
