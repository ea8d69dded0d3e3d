"""Continual grounding learner, the 12-task GLIP loop (counterpart of
`lpi_tpu/continual/grounding_learner.py`).

Per task a fresh AdamW with full-update clipping and a per-epoch cosine
learning rate trains ONLY that task's rows of the prompt and interaction
pools: ATSS grounding losses x0.8 + alignment x0.1 + inter-task x0.1, each
non-finite loss zeroed; then k-means task keys over the frozen P7 features.

The optimizer is written out to match optax's `clip_by_global_norm`
followed by `adamw` (b1 0.9, b2 0.999, eps 1e-8, bias correction, decay
added to the Adam direction), with a one-hot over the leading task axis on
the gradients and on the updates: `torch.optim.AdamW` would decay the frozen
tasks' rows, and `clip_grad_norm_` adds 1e-6 to the norm. The frozen
parameters have requires_grad=False, so autograd computes gradients for the
pools alone, as JAX differentiates with respect to them alone.

`evaluate` infers each eval image's task from the frozen P7 features and
the task keys, runs the eval forward with that task's prompts, postprocesses
the boxes of the first entity and scores RefExp P@1/5/10 (GIoU >= 0.5) per
task, with the task-ID accuracy beside it.

`restore` loads a `core.checkpoint.SessionCheckpointer` task (the frozen
base and that task's pools) into the model's own tensors, in place, so a
step captured before it trains the restored weights; the task keys, which
no captured step reads, are replaced.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional

import numpy as np
import torch

from lpi_tpu_torch.config import GroundingConfig
from lpi_tpu_torch.continual.common import (AdamState, adamw_apply,  # noqa: F401
                                             adamw_update, clip_by_global_norm, freeze,
                                             restore_in_place, staged_lrs)
from lpi_tpu_torch.continual.keys import TaskKeys, exact_fp32, infer_task_ids
from lpi_tpu_torch.data.grounding import GroundingTaskSet
from lpi_tpu_torch.eval.refexp import RefExpEvaluator
from lpi_tpu_torch.graphs import Graphed, captures
from lpi_tpu_torch.models.glip.atss import atss_losses
from lpi_tpu_torch.models.glip.grounding import (GroundedVLModel, grounding_aux_losses,
                                                 init_parameters)
from lpi_tpu_torch.models.glip.postprocess import atss_postprocess_batch
from lpi_tpu_torch.ops.kmeans import kmeans

POOL_KEYS = ("prompts", "interact")

_BATCH_DTYPES = {"images": torch.float32, "input_ids": torch.long,
                 "attention_mask": torch.float32, "gt_boxes": torch.float32,
                 "gt_valid": torch.bool, "positive_map": torch.float32}


class _Session(NamedTuple):
    task_id: torch.Tensor  # 0-d int64
    lr: torch.Tensor  # 0-d fp32
    state: AdamState


class GroundingLearner:
    """`init_params` is a state_dict (as `bridge.params_from_jax` returns)
    whose entries replace the seeded initial parameters; `generator` seeds
    those (default: `cfg.seed`). Runs on `device`, the card unless asked
    otherwise."""

    def __init__(self, cfg: GroundingConfig, task_sim_matrix: Optional[np.ndarray] = None,
                 init_params: Optional[Mapping[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        model = GroundedVLModel(cfg)
        init_parameters(model, generator if generator is not None
                        else torch.Generator().manual_seed(cfg.seed))
        if init_params is not None:
            unexpected = model.load_state_dict(dict(init_params), strict=False).unexpected_keys
            if unexpected:
                raise KeyError(f"init_params has entries the model lacks: {unexpected[:5]}")
        self.model = model.to(self.device)
        self.pools, self.frozen = freeze(self.model, POOL_KEYS)
        T = cfg.total_tasks
        sim = np.eye(T, dtype=np.float32) if task_sim_matrix is None else np.asarray(
            task_sim_matrix)
        self.task_relation = torch.tensor((sim > cfg.lpi.task_sim_threshold).astype(np.float32),
                                          device=self.device)
        self.keys: Optional[TaskKeys] = None  # created at the first cluster_task
        self._session: Optional[_Session] = None
        self._graphs: Dict[tuple, Graphed] = {}  # captured steps by batch shapes

    def to_device(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """The batch's model inputs on the learner's device, from numpy
        arrays or tensors."""
        return {k: (v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v)))
                .to(self.device, _BATCH_DTYPES[k])
                for k, v in batch.items() if k in _BATCH_DTYPES}

    # ------------------------------------------------------------------
    def _losses(self, batch: Mapping[str, torch.Tensor], task_id: int):
        """-> (total loss, metrics): the three ATSS terms x
        `proposal_loss_weight`, the auxiliary losses, each zeroed where not
        finite, and `num_pos`."""
        cfg = self.cfg
        flat, _, vis_p, txt_p = self.model(batch["images"], batch["input_ids"],
                                           batch["attention_mask"], task_id)
        det = atss_losses(flat["anchors"], tuple(flat["level_counts"]), flat["bbox_pred"],
                          flat["centerness"], flat["dot_logits"], batch["gt_boxes"],
                          batch["gt_valid"], batch["positive_map"], batch["attention_mask"],
                          topk=cfg.atss.topk, reg_loss_weight=cfg.atss.reg_loss_weight)
        w = cfg.proposal_loss_weight
        losses = {"loss_reg": w * det["loss_reg"],
                  "loss_centerness": w * det["loss_centerness"],
                  "loss_dot_product_token": w * det["loss_dot_product_token"]}
        vis_all, txt_all = self.model.prompts.all_prompts()
        losses.update(grounding_aux_losses(vis_p, txt_p, vis_all, txt_all, task_id,
                                           self.task_relation, cfg))
        losses = {k: torch.where(torch.isfinite(v), v, torch.zeros_like(v))
                  for k, v in losses.items()}
        total = sum(losses.values())
        return total, {**losses, "num_pos": det["num_pos"]}

    def _step(self, batch: Mapping[str, torch.Tensor], task_id, lr, state: AdamState,
              params: List[torch.nn.Parameter],
              masked: bool = True) -> Dict[str, torch.Tensor]:
        """One train step on `params` at the state's current count (the
        caller advances it): gradients, the one-hot of `task_id` over the
        leading task axis (when `masked`), the global-norm clip, AdamW, the
        one-hot again on the updates. `batch` is on the device; `task_id` is
        an int or a 0-d device tensor, `lr` a float or a 0-d device tensor:
        nothing here reads a value back to the host, so it can be captured."""
        cfg = self.cfg
        total, metrics = self._losses(batch, task_id)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        masks = None
        if masked:
            masks = [(torch.arange(p.shape[0], device=p.device) == task_id).to(p.dtype)
                     .reshape((-1,) + (1,) * (p.dim() - 1)) for p in params]
            grads = [g * mk for g, mk in zip(grads, masks)]
        grads = clip_by_global_norm(grads, cfg.grad_clip)
        adamw_apply(params, grads, state, lr, cfg.weight_decay, masks)
        return {"total": total.detach(), **{k: v.detach() for k, v in metrics.items()}}

    def _session_state(self) -> _Session:
        """The session inputs that every session's step reads: the task id
        and lr as 0-d device tensors and the AdamW state, created once and
        reset in place by each `make_step`."""
        if self._session is None:
            self._session = _Session(torch.zeros((), dtype=torch.int64, device=self.device),
                                     torch.zeros((), dtype=torch.float32, device=self.device),
                                     AdamState.zeros(list(self.pools.values())))
        return self._session

    def make_step(self, task_id: int, steps_per_epoch: int, epochs: int,
                  eager: bool = False) -> Callable[[Mapping], Dict[str, torch.Tensor]]:
        """A session's masked step with a fresh optimizer and the per-epoch
        cosine learning rate lrs[min(step // steps_per_epoch, epochs)]:
        `step(batch)` -> metrics (device tensors). The session's task id,
        learning rates and AdamW state are written in place into the
        learner's one set of session inputs, so a new `make_step` ends the
        previous session. On the card the step is captured as one CUDA graph
        at its first batch of a new shape and replayed, the capture shared
        by every session as the JAX package compiles its step once per run;
        its metrics are static tensors that the next step overwrites.
        `eager=True` (or a CPU learner) runs it op by op."""
        sess = self._session_state()
        sess.state.reset()
        sess.task_id.fill_(task_id)
        lrs = staged_lrs(self.cfg.lr, epochs, self.device)
        params = list(self.pools.values())
        count = itertools.count()
        capture = captures(self.device) and not eager

        def run(b):
            return self._step(b, sess.task_id, sess.lr, sess.state, params)

        def step(batch):
            epoch = next(count) // max(steps_per_epoch, 1)
            sess.lr.copy_(lrs[min(epoch, epochs)])
            sess.state.advance()
            if not capture:
                return run(self.to_device(batch))
            key = tuple((k, tuple(np.shape(batch[k]))) for k in sorted(_BATCH_DTYPES)
                        if k in batch)
            if key not in self._graphs:
                self._graphs[key] = Graphed(
                    run, self.to_device(batch),
                    state=[*params, *sess.state.mu, *sess.state.nu])
            return self._graphs[key](batch)

        return step

    def pretrain(self, dataset: GroundingTaskSet, steps: int,
                 lr: Optional[float] = None) -> Dict[str, float]:
        """Full-parameter training with no task masks at task 0 (the
        reference's FULL tuning preset), then the frozen split again. Runs
        eagerly on every device."""
        cfg = self.cfg
        lr = cfg.lr if lr is None else lr
        params = dict(self.model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        state = AdamState.zeros(list(params.values()))
        metrics = {}
        it = iter([])
        try:
            for n in range(steps):
                batch = next(it, None)
                if batch is None:
                    it = dataset.batches(cfg.batch_size, seed=cfg.seed + n)
                    batch = next(it)
                state.advance()
                metrics = self._step(self.to_device(batch), 0, lr, state,
                                     list(params.values()), masked=False)
        finally:
            self.pools, self.frozen = freeze(self.model, POOL_KEYS)
        return {k: float(v) for k, v in metrics.items()}

    def train_task(self, dataset: GroundingTaskSet,
                   epochs: Optional[int] = None) -> Dict[str, float]:
        """Train the session of `dataset.task_index`, then set its task keys."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs_per_task
        step = self.make_step(dataset.task_index, max(len(dataset) // cfg.batch_size, 1),
                              epochs)
        metrics = {}
        t0 = time.perf_counter()
        steps = 0
        for epoch in range(epochs):
            for batch in dataset.batches(cfg.batch_size, seed=cfg.seed + epoch):
                metrics = step(batch)
                steps += 1
        out = {k: float(v) for k, v in metrics.items()}
        out["samples_per_sec"] = steps * cfg.batch_size / max(time.perf_counter() - t0, 1e-9)
        self.cluster_task(dataset)
        return out

    # ------------------------------------------------------------------
    def extract_features(self, images) -> torch.Tensor:
        """Frozen promptless P7 features for the task keys, in exact fp32
        (TF32 off)."""
        images = torch.as_tensor(np.asarray(images)).to(self.device, torch.float32)
        with torch.no_grad(), exact_fp32():
            return self.model.extract_features(images)

    def cluster_task(self, dataset: GroundingTaskSet) -> None:
        cfg = self.cfg
        feats = torch.cat([self.extract_features(b["images"]) for b in
                           dataset.batches(cfg.batch_size, seed=0, drop_remainder=False)])
        feats = feats[:len(dataset)]
        if self.keys is None:
            self.keys = TaskKeys.create(cfg.total_tasks, cfg.num_key_clusters,
                                        feats.shape[-1], device=self.device)
        centers, _ = kmeans(feats, torch.Generator().manual_seed(0), k=cfg.num_key_clusters)
        self.keys = self.keys.update(dataset.task_index, centers)

    def restore(self, checkpointer, session: Optional[int] = None) -> int:
        """Load the frozen base and a task's pools and keys (the latest task
        by default) from a `SessionCheckpointer`, in place; -> the task
        restored. A checkpoint whose names or shapes differ from the
        model's is refused, naming the first mismatch."""
        session, state = restore_in_place(checkpointer, session, {**self.frozen, **self.pools})
        if "visual_keys" in state:
            self.keys = TaskKeys.from_state(state["visual_keys"], self.cfg.total_tasks,
                                            self.cfg.num_key_clusters, self.device)
        return session

    def evaluate(self, task_sets: Mapping[int, GroundingTaskSet],
                 batch_size: Optional[int] = None) -> dict:
        """RefExp over the seen tasks' sets, each image's task inferred from
        the task keys. -> {'per_task': {t: [P@1, P@5, P@10]}, 'overall':
        [...] (percent), 'task_id_accuracy': fraction}."""
        cfg = self.cfg
        bs = batch_size or cfg.batch_size
        evaluator = RefExpEvaluator()
        hits = total = 0
        for tid, ds in task_sets.items():
            for batch, real, indices in ds.eval_batches(bs):
                sel = infer_task_ids(self.extract_features(batch["images"]), self.keys)
                hits += int((sel[:real] == tid).sum())
                total += real
                b = self.to_device(batch)
                with torch.no_grad():
                    flat, _ = self.model.forward_tasks(b["images"], b["input_ids"],
                                                       b["attention_mask"], sel)
                    A = flat["anchors"].shape[0]
                    out = atss_postprocess_batch(
                        flat["anchors"], tuple(int(c) for c in flat["level_counts"]),
                        flat["bbox_pred"], flat["centerness"], flat["dot_logits"],
                        b["positive_map"][:, :1],  # the first entity [B, 1, T]
                        pre_nms_top_n=min(cfg.atss.pre_nms_top_n, A),
                        post_nms_top_n=min(cfg.atss.fpn_post_nms_top_n, A),
                        nms_thresh=cfg.atss.nms_thresh,
                        pre_nms_thresh=cfg.atss.inference_thresh)
                out = {k: v.cpu().numpy() for k, v in out.items()}
                for i in range(real):
                    valid = out["valid"][i]
                    evaluator.update(image_index=indices[i], boxes=out["boxes"][i][valid],
                                     scores=out["scores"][i][valid],
                                     gt_box=batch["gt_boxes"][i][batch["gt_valid"][i]][0],
                                     task_index=tid)
        res = evaluator.summarize(num_tasks=max(task_sets) + 1)
        res["task_id_accuracy"] = hits / max(total, 1)
        return res
