"""CLIP ViT-B/16 + LPI (`"family": "clip"`): the program side of a cell,
its weights and batches, and the plain reference's training step.

The program is `lpi_tpu_torch.continual.learner.RetrievalLearner` on the
configuration file's `retrieval` tree, one continual session's captured
masked SGD step (`make_train_step`) under
`lpi_tpu_torch.bench.deterministic()`, as the `train` command runs it. The
reference (`reference/clip/`) is a frozen plain copy of SliNet, fp32, with
its own loss sum and masked SGD, and imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.families.glip import namespace
from benchmark.traffic import weights as weights_lib

POOL_KEYS = ("prompts", "ctx_pool")


def reference_config(conf: dict, dtype: str = "float32"):
    return namespace({**conf["retrieval"], "dtype": dtype})


def reference_model(conf: dict, device, dtype: str = "float32"):
    from benchmark.reference.clip.slinet import SliNet

    with torch.device(device):
        return SliNet(reference_config(conf, dtype))


def rule(conf: dict):
    """The law of each parameter, the port's seeded initialisers (normal in
    place of Flax's truncated normal)."""
    c = reference_config(conf).clip
    stds = {"clip.visual.class_embedding": c.vision_width ** -0.5,
            "clip.visual.positional_embedding": c.vision_width ** -0.5,
            "clip.visual.proj": c.vision_width ** -0.5,
            "clip.text.positional_embedding": 0.01,
            "clip.text.text_projection": c.text_width ** -0.5,
            "clip.token_embedding": 0.02, "ctx_pool": 0.02}

    def law(name, shape):
        leaf = name.rsplit(".", 1)[-1]
        if name in stds:
            return "normal", stds[name], None
        if name.startswith("prompts."):
            return "normal", 0.5, None
        if name == "clip.logit_scale":
            return "const", float(c.logit_scale_init), None
        if leaf == "weight" and len(shape) >= 2:
            return "normal", 1.0 / math.sqrt(math.prod(shape[1:])), None
        if leaf == "weight":
            return "const", 1.0, None
        return "const", 0.0, None

    return law


def make_weights(conf: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    model = reference_model(conf, "meta")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return weights_lib.make(shapes, rule(conf), seed, device)


def program_config(conf: dict):
    from lpi_tpu_torch.config import load_config

    return load_config(overrides={"task": "retrieval", "retrieval": conf["retrieval"]}).retrieval


class Trainer:
    """One session's step of the port's learner at task `traffic["task"]`."""

    def __init__(self, conf: dict, weights: Dict[str, torch.Tensor], traffic: dict, device):
        from lpi_tpu_torch.continual.learner import RetrievalLearner

        self.cfg = cfg = program_config(conf)
        self.learner = RetrievalLearner(cfg, init_params=weights, device=device)
        names = {n for n, _ in self.learner.model.named_parameters()}
        if names != set(weights):
            raise KeyError(f"weights and model differ: {sorted(names ^ set(weights))[:5]}")
        self.task = traffic["task"]
        self.step = self.learner.make_train_step(self.task, traffic["steps_per_epoch"],
                                                 cfg.epochs)
        self.pools = dict(self.learner.pools)
        self.frozen = dict(self.learner.frozen)
        self._start = {n: p[self.task].detach().clone() for n, p in self.pools.items()}

    @staticmethod
    def mode():
        from lpi_tpu_torch.bench import deterministic

        return deterministic()

    @staticmethod
    def terms(out) -> Dict[str, torch.Tensor]:
        """The step's loss terms and their total, as the step returned them."""
        return dict(out)

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """The gradient the optimizer took at the first step, from its
        momentum (t1 = g + wd p0), the task's row of each pool leaf."""
        trace = self.learner._session.trace
        wd = self.cfg.weight_decay
        return {n: (t[self.task] - wd * self._start[n]).clone()
                for n, t in zip(self.pools, trace)}


def reference_steps(conf: dict, weights: Dict[str, torch.Tensor], batches: List[dict],
                    task: int, steps: int, device, lower: bool = False,
                    record: Optional[list] = None, flops: Optional[list] = None,
                    dtype: str = "float32") -> dict:
    """`steps` masked SGD steps of the session at `task` from `weights` on
    `batches`, fp32 with TF32 off (or, with `lower`, every product in fp8).
    -> {"losses", "grads" (the first step's gradient, the task's row),
    "params" (the task's row after the steps)}."""
    from benchmark.reference.clip_loss import alignment_loss, clip_loss, task_prompt_loss_masked
    from benchmark.reference.layers import lower_precision

    c = reference_config(conf, dtype)
    lpi = c.lpi
    model = reference_model(conf, device, dtype)
    missing = {n for n, _ in model.named_parameters()} - set(weights)
    if missing:
        raise KeyError(f"weights lack {sorted(missing)[:5]}")
    model.load_state_dict(weights, strict=False)
    pools = {n: p for n, p in model.named_parameters() if any(k in n for k in POOL_KEYS)}
    for n, p in model.named_parameters():
        p.requires_grad_(n in pools)
    params = list(pools.values())
    T = c.total_sessions
    relation = (torch.eye(T, device=device) > lpi.task_sim_threshold).float()
    lr = float(np.float32(c.lr))  # epoch 0 of the cosine schedule
    trace = [torch.zeros_like(p) for p in params]
    out = {"losses": [], "grads": {}, "params": {}}
    prec = lower_precision if lower else contextlib.nullcontext
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for n in range(steps):
            b = {"images": torch.as_tensor(batches[n]["images"]).to(device, torch.float32),
                 "token_ids": torch.as_tensor(batches[n]["token_ids"]).to(device, torch.long)}
            with prec(), contextlib.ExitStack() as stack:
                if n == 0 and flops is not None:
                    from torch.utils.flop_counter import FlopCounterMode

                    counter = stack.enter_context(FlopCounterMode(display=False))
                img, txt, vis_p, txt_p, scale = model(b["images"], b["token_ids"], task)
                vis_all, txt_all = model.all_task_prompts()
                terms = {"base_loss": clip_loss(scale * img @ txt.T),
                         "alignment_loss": lpi.alignment_weight * alignment_loss(
                             vis_p, txt_p, lpi.alignment_temperature),
                         "task_loss": lpi.task_loss_weight * task_prompt_loss_masked(
                             vis_all.reshape(T, -1), txt_all.reshape(T, -1), relation, task,
                             lpi.task_temperature)}
                total = sum(terms.values())
                terms["total"] = total
                grads = torch.autograd.grad(total, params, allow_unused=True)
                if n == 0 and flops is not None:
                    flops.append(counter.get_total_flops())
            out["losses"].append({k: float(v.detach()) for k, v in terms.items()})
            with torch.no_grad():
                for i, (name, p, g) in enumerate(zip(pools, params, grads)):
                    m = (torch.arange(p.shape[0], device=device) == task).float().reshape(
                        (-1,) + (1,) * (p.dim() - 1))
                    g = torch.zeros_like(p) if g is None else g * m
                    if n == 0:
                        out["grads"][name] = g[task].clone()
                    trace[i] = g + c.weight_decay * p + c.momentum * trace[i]
                    p.add_(-lr * trace[i] * m)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    out["params"] = {k: p[task].detach().clone() for k, p in pools.items()}
    return out


def step_flops(conf: dict, traffic: dict, counted: Optional[int]) -> int:
    """The analytic count of `counts/clip.py`."""
    from benchmark.counts.clip import step_flops as count

    return count(conf, traffic["batch"])


def window_bound_s(conf: dict, record: list) -> None:
    """No window sums run in this model."""
    return None
