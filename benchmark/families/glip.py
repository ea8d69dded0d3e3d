"""GLIP-T + LPI (`"family": "glip"`): the program side of a cell, its
weights and batches, and the plain reference's training step.

The program is `lpi_tpu_torch.continual.grounding_learner.GroundingLearner`
on the configuration file's `grounding` tree, one continual session's
captured step (`make_step`) under `lpi_tpu_torch.bench.deterministic()`, as
the `train-grounding` command runs it. The reference (`reference/glip/`)
is a frozen plain copy of the model, fp32, with its own deformable conv
(`reference/deform.py`), its own loss sum and masked AdamW, and imports
nothing of the program.
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.traffic import weights as weights_lib

POOL_KEYS = ("prompts", "interact")  # the parameters a session trains, by name
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def namespace(tree):
    """A configuration tree as attributes (lists as tuples)."""
    if isinstance(tree, dict):
        return SimpleNamespace(**{k: namespace(v) for k, v in tree.items()})
    if isinstance(tree, list):
        return tuple(namespace(v) for v in tree)
    return tree


def reference_config(conf: dict, dtype: str = "float32") -> SimpleNamespace:
    return namespace({**conf["grounding"], "dtype": dtype})


def reference_model(conf: dict, device, dtype: str = "float32"):
    from benchmark.reference.glip.grounding import GroundedVLModel

    with torch.device(device):
        return GroundedVLModel(reference_config(conf, dtype))


def rule(conf: dict):
    """The law of each parameter: the port's seeded initialisers (normal in
    place of Flax's truncated normal), with the head's offset convs as the
    configuration's `weights` says (`honest_offsets`' arithmetic: kernels
    N(0, 0.01) x `offset_kernel_scale`, the first `offset_bias_count` biases
    N(0, `offset_bias_std`^2), the rest 0)."""
    c = reference_config(conf)
    prior = -math.log((1 - c.dyhead.prior_prob) / c.dyhead.prior_prob)
    w = conf["weights"]

    def law(name, shape):
        leaf = name.rsplit(".", 1)[-1]
        parts = name.split(".")
        if name.startswith("prompts."):
            return "normal", 0.5, None
        if name.startswith("encoder.interact."):
            if leaf.startswith("d"):
                return "uniform", 1.0 / math.sqrt(c.lpi.interact_rank), None
            return "const", 1.0 if leaf.endswith("scale") else 0.0, None
        if leaf in ("word_embeddings", "position_embeddings", "token_type_embeddings",
                    "relative_position_bias_table"):
            return "normal", 0.02, None
        if name == "tunable_linear.weight":
            return "const", 0.0, None
        if name == "head.scales":
            return "const", 1.0, None
        if name == "head.log_scale":
            return "const", float(c.dyhead.log_scale), None
        if name in ("head.bias0", "head.cls_logits.bias"):
            return "const", prior, None
        if name.startswith("head.towers.") and parts[-2] == "offset":
            if leaf == "weight":
                return "normal", 0.01 * w["offset_kernel_scale"], None
            return "normal", w["offset_bias_std"], w["offset_bias_count"]
        if leaf == "weight" and len(shape) == 4 and name.startswith("head."):
            return "normal", 0.01, None
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


# --------------------------------------------------------------------------
# the program
# --------------------------------------------------------------------------

def program_config(conf: dict):
    from lpi_tpu_torch.config import load_config

    return load_config(overrides={"task": "grounding", "grounding": conf["grounding"]}).grounding


class Trainer:
    """One session's step of the port's learner at task `traffic["task"]`."""

    def __init__(self, conf: dict, weights: Dict[str, torch.Tensor], traffic: dict, device):
        from lpi_tpu_torch.continual.grounding_learner import GroundingLearner

        cfg = program_config(conf)
        self.learner = GroundingLearner(cfg, init_params=weights, device=device)
        names = {n for n, _ in self.learner.model.named_parameters()}
        if names != set(weights):
            raise KeyError(f"weights and model differ: {sorted(names ^ set(weights))[:5]}")
        self.task = traffic["task"]
        self.step = self.learner.make_step(self.task, traffic["steps_per_epoch"],
                                           cfg.epochs_per_task)
        self.pools = dict(self.learner.pools)
        self.frozen = dict(self.learner.frozen)

    @staticmethod
    def mode():
        from lpi_tpu_torch.bench import deterministic

        return deterministic()

    @staticmethod
    def terms(out) -> Dict[str, torch.Tensor]:
        """The step's loss terms and their total, as the step returned them."""
        return {k: v for k, v in out.items() if k != "num_pos"}

    def first_grads(self) -> Dict[str, torch.Tensor]:
        """The gradient the optimizer took at the first step, from its first
        moment (m1 = (1 - b1) g), the task's row of each pool leaf."""
        mu = self.learner._session.state.mu
        return {n: (m[self.task] / (1 - ADAM_B1)).clone() for n, m in zip(self.pools, mu)}


# --------------------------------------------------------------------------
# the plain reference
# --------------------------------------------------------------------------

def _to_device(batch: dict, device) -> dict:
    dtypes = {"images": torch.float32, "input_ids": torch.long, "attention_mask": torch.float32,
              "gt_boxes": torch.float32, "gt_valid": torch.bool, "positive_map": torch.float32}
    return {k: torch.as_tensor(v).to(device, dtypes[k]) for k, v in batch.items() if k in dtypes}


def reference_losses(model, c, batch: dict, task: int, task_relation: torch.Tensor):
    """The step's loss as the configuration states it: the ATSS terms x
    `proposal_loss_weight`, alignment and inter-task losses, each zeroed where
    not finite. -> (total, {term: value} with the total)."""
    from benchmark.reference.glip.atss import atss_losses
    from benchmark.reference.glip.grounding import grounding_aux_losses

    flat, _, vis_p, txt_p = model(batch["images"], batch["input_ids"], batch["attention_mask"],
                                  task)
    det = atss_losses(flat["anchors"], tuple(flat["level_counts"]), flat["bbox_pred"],
                      flat["centerness"], flat["dot_logits"], batch["gt_boxes"],
                      batch["gt_valid"], batch["positive_map"], batch["attention_mask"],
                      topk=c.atss.topk, reg_loss_weight=c.atss.reg_loss_weight)
    losses = {k: c.proposal_loss_weight * det[k]
              for k in ("loss_reg", "loss_centerness", "loss_dot_product_token")}
    vis_all, txt_all = model.prompts.all_prompts()
    losses.update(grounding_aux_losses(vis_p, txt_p, vis_all, txt_all, task, task_relation, c))
    losses = {k: torch.where(torch.isfinite(v), v, torch.zeros_like(v)) for k, v in losses.items()}
    total = sum(losses.values())
    return total, {"total": total, **losses}


def reference_steps(conf: dict, weights: Dict[str, torch.Tensor], batches: List[dict],
                    task: int, steps: int, device, lower: bool = False,
                    record: Optional[list] = None, flops: Optional[list] = None,
                    dtype: str = "float32") -> dict:
    """`steps` masked AdamW steps of the session at `task` from `weights`
    on `batches`, fp32 with TF32 off (or, with `lower`, every product in
    fp8: the check's control). -> {"losses": [{term: value}, ...], "grads": {leaf: the
    first step's clipped gradient, the task's row}, "params": {leaf: the
    task's row after the steps}}. `record` gets the first forward's deform
    offsets and `flops` the first step's product operations."""
    from benchmark.reference.layers import lower_precision

    c = reference_config(conf, dtype)
    model = reference_model(conf, device, dtype)
    missing = {n for n, _ in model.named_parameters()} - set(weights)
    if missing:
        raise KeyError(f"weights lack {sorted(missing)[:5]}")
    model.load_state_dict(weights, strict=False)
    pools = {n: p for n, p in model.named_parameters() if any(k in n for k in POOL_KEYS)}
    for n, p in model.named_parameters():
        p.requires_grad_(n in pools)
    params = list(pools.values())
    T = c.total_tasks
    relation = (torch.eye(T, device=device) > c.lpi.task_sim_threshold).float()
    lr = float(np.float32(c.lr))  # epoch 0 of the cosine schedule
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    out = {"losses": [], "grads": {}, "params": {}}
    prec = lower_precision if lower else contextlib.nullcontext
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for n in range(steps):
            b = _to_device(batches[n], device)
            with prec(), contextlib.ExitStack() as stack:
                if n == 0 and record is not None:
                    offsets = stack.enter_context(model.head.record_offsets())
                if n == 0 and flops is not None:
                    from torch.utils.flop_counter import FlopCounterMode

                    counter = stack.enter_context(FlopCounterMode(display=False))
                total, terms = reference_losses(model, c, b, task, relation)
                grads = torch.autograd.grad(total, params, allow_unused=True)
                if n == 0 and flops is not None:
                    flops.append(counter.get_total_flops())
            if n == 0 and record is not None:
                record.extend(offsets)
            out["losses"].append({k: float(v.detach()) for k, v in terms.items()})
            with torch.no_grad():
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
                masks = [(torch.arange(p.shape[0], device=device) == task).float()
                         .reshape((-1,) + (1,) * (p.dim() - 1)) for p in params]
                grads = [g * m for g, m in zip(grads, masks)]
                norm = torch.sqrt(sum((g * g).sum() for g in grads))
                if norm >= c.grad_clip:
                    grads = [g / norm * c.grad_clip for g in grads]
                if n == 0:
                    out["grads"] = {k: g[task].clone() for k, g in zip(pools, grads)}
                for i, (p, g, m) in enumerate(zip(params, grads, masks)):
                    mu[i] = (1 - ADAM_B1) * g + ADAM_B1 * mu[i]
                    nu[i] = (1 - ADAM_B2) * g * g + ADAM_B2 * nu[i]
                    mhat = mu[i] / (1 - ADAM_B1 ** (n + 1))
                    vhat = nu[i] / (1 - ADAM_B2 ** (n + 1))
                    p.add_(-lr * (mhat / (torch.sqrt(vhat) + ADAM_EPS) + c.weight_decay * p) * m)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    out["params"] = {k: p[task].detach().clone() for k, p in pools.items()}
    return out


def step_flops(conf: dict, traffic: dict, counted: Optional[int]) -> Optional[int]:
    """The model's product operations in one step: the reference's first
    step counted by `FlopCounterMode` (forward, and the gradients of the
    activations that lead to the pools)."""
    return counted


def window_bound_s(conf: dict, record: list) -> Optional[float]:
    """The least seconds of one step's window sums (`counts/glip.py`) at the
    offsets the reference recorded; the product maps are bf16 in a bf16
    model, as `deform_dtype` "auto" says."""
    from benchmark.counts.glip import window_bound_s as bound

    g = conf["grounding"]
    dy = g["dyhead"]
    bf16 = dy["deform_dtype"] == "bfloat16" or (dy["deform_dtype"] == "auto"
                                                 and g["dtype"] == "bfloat16")
    return bound(record, dy["channels"], 2 if bf16 else 4, dy["deform_window"])


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def p7_side(image_size: int) -> int:
    """The side of P7: the image over 32 (Swin's last stage), halved twice
    with 'SAME' padding."""
    side = -(-image_size // 32)
    for _ in range(2):
        side = -(-side // 2)
    return side


def make_keys(conf: dict, seed: int, device):
    """Task keys of every task (frozen from `chip_smoke.seeded_keys`): random
    centres of unit scale in the P7 feature space, every task valid, drawn
    on the device from the seed. -> (centres [T, k, D], valid [T])."""
    g = conf["grounding"]
    dim = g["dyhead"]["channels"] * p7_side(g["image_size"]) ** 2
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 2 + 2) % (2 ** 63))
    centers = torch.randn(g["total_tasks"], g["num_key_clusters"], dim, generator=gen,
                          device=device) / math.sqrt(dim)
    return centers, torch.ones(g["total_tasks"], dtype=torch.bool, device=device)


class Server:
    """The port's `GroundingPredictor` built as the `serve` command builds
    it (the configuration's image size and ATSS settings, captured, not
    under deterministic algorithms), with the traffic's score and pre-NMS
    thresholds and the seeded task keys."""

    def __init__(self, conf: dict, weights: Dict[str, torch.Tensor], keys, traffic: dict,
                 device):
        import dataclasses

        from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
        from lpi_tpu_torch.continual.keys import TaskKeys
        from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
        from lpi_tpu_torch.serve.predictor import GroundingPredictor

        cfg = program_config(conf)
        learner = GroundingLearner(cfg, init_params=weights, device=device)
        names = {n for n, _ in learner.model.named_parameters()}
        if names != set(weights):
            raise KeyError(f"weights and model differ: {sorted(names ^ set(weights))[:5]}")
        atss = dataclasses.replace(cfg.atss, inference_thresh=traffic["pre_nms_thresh"])
        tok = BertTokenizer(max_len=cfg.bert.max_query_len, vocab_size=cfg.bert.vocab_size)
        self.predictor = GroundingPredictor(
            learner.model, TaskKeys(keys[0].clone(), keys[1].clone()), tok,
            image_size=cfg.image_size, score_thresh=traffic["score_thresh"], atss_cfg=atss,
            device=device)

    @staticmethod
    def mode():
        return contextlib.nullcontext()

    def request(self, image: np.ndarray, caption: str) -> dict:
        return self.predictor.predict(image, caption)


def reference_server(conf: dict, weights: Dict[str, torch.Tensor], keys, device,
                     dtype: str = "float32"):
    """The reference model for requests, fp32 with TF32 off while it runs."""
    model = reference_model(conf, device, dtype)
    model.load_state_dict(weights, strict=False)
    for p in model.parameters():
        p.requires_grad_(False)
    return model.eval()


@torch.no_grad()
def reference_request(model, conf: dict, keys, traffic: dict, image: np.ndarray,
                      caption: str, device, lower: bool = False,
                      flops: Optional[list] = None) -> dict:
    """One request worked out by the reference (`reference/request.py`):
    -> {"distances": [T] each task's L1 distance, "task", "boxes" [K, 4] in
    the image's coordinates, "scores" [K], and the candidates before NMS,
    "cand_boxes", "cand_scores"}; `flops` gets the product operations of
    the task-id pass and the forward."""
    from benchmark.reference import request as R
    from benchmark.reference.layers import lower_precision

    g = conf["grounding"]
    size = g["image_size"]
    canvas, (sx, sy) = R.prepare_image(image, size)
    spans, _ = R.entities(caption)
    ids, mask, ranges = R.tokenize(caption, g["bert"]["max_query_len"], g["bert"]["vocab_size"])
    tmap = torch.from_numpy(R.token_map(spans, ranges, ids.shape[1])).to(device)
    images = torch.from_numpy(canvas).to(device)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with (lower_precision() if lower else contextlib.nullcontext()), \
                contextlib.ExitStack() as stack:
            if flops is not None:
                from torch.utils.flop_counter import FlopCounterMode

                counter = stack.enter_context(FlopCounterMode(display=False))
            dist = R.task_distances(model.extract_features(images)[0], keys[0])
            dist = torch.where(keys[1], dist, torch.full_like(dist, float("inf")))
            task = int(torch.argmin(dist))
            flat, _ = model.forward_tasks(images, torch.from_numpy(ids).to(device),
                                          torch.from_numpy(mask).to(device),
                                          torch.tensor([task], device=device))
            if flops is not None:
                flops.append(counter.get_total_flops())
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    a = g["atss"]
    n = flat["anchors"].shape[0]
    det = R.detections(flat, tmap, size, traffic["pre_nms_thresh"], min(a["pre_nms_top_n"], n),
                       min(a["fpn_post_nms_top_n"], n), a["nms_thresh"])
    keep = det["scores"] > traffic["score_thresh"]
    scale = torch.tensor([sx, sy, sx, sy], device=device)
    return {"distances": dist.cpu().numpy(), "task": task,
            "boxes": (det["boxes"][keep] / scale).cpu().numpy(),
            "scores": det["scores"][keep].cpu().numpy(),
            "cand_boxes": (det["cand_boxes"] / scale).cpu().numpy(),
            "cand_scores": det["cand_scores"].cpu().numpy()}
