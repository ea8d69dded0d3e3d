"""Continual retrieval learner, the 12-session SliNet loop (counterpart of
`lpi_tpu/continual/learner.py`).

* Per session a fresh SGD with momentum 0.9, weight decay and a per-epoch
  cosine learning rate trains ONLY the current task's slices of the prompt
  and context pools: the frozen towers have requires_grad=False, so
  autograd computes gradients for the pools alone.
* Loss: batch-global InfoNCE; with `prompt_type="lpi"` also 0.1 x
  cross-modal prompt alignment + 0.1 x the inter-task loss (masked to
  tasks 0..task; 0 at task 0), each where its flag is on.
* After each session: k-means task keys per modality over the session's
  frozen promptless features, in exact fp32.
* Evaluation: each image's and caption's task inferred from its frozen
  features and the keys, the prompts gathered per sample, the features
  ranked on the device, R@1/5/10 per task and the task-ID accuracy. The
  zero-shot "clip" type ranks the frozen features and takes task 0 for
  every sample; "l2p" has no evaluation (`SliNet.encode_image_tasks`).

The masked step is optax's `add_decayed_weights(wd)` then `sgd(lr,
momentum)` written out, with a one-hot over the leading task axis on the
gradients and on the updates: g <- g * onehot; u = g + wd p over every
slice; trace <- u + 0.9 trace; p <- p - lr (trace * onehot). `torch.optim.SGD`
would move the other tasks' slices through the decay. A leaf that the
forward never reads gets no gradient (None, taken as zero), and its
current slice still decays: `ctx_pool` under "lpi", "sprompts" and "clip"
(L2P's text reads it), L2P's `prompt_key` (its similarity only picks
indices). L2P's shared pool has one row per session, so session t moves
row t of it alone. The task id and the learning rate are
device tensors, so a step neither syncs with the host nor depends on their
values for its shape of work.

`pretrain` trains every parameter at task 0 with optax's
`clip_by_global_norm(1.0)` then `adamw(weight_decay=0)`
(`continual.common`): the role the OpenAI CLIP weights play in the real
recipe, which the quality gate needs because the repo carries no
checkpoint.

`restore` loads a `core.checkpoint.SessionCheckpointer` session (the frozen
base and that session's pools) into the model's own tensors, in place, so a
step captured before it trains the restored weights; the task keys, which
no captured step reads, are replaced.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Mapping, NamedTuple, Optional

import numpy as np
import torch

from lpi_tpu_torch.config import RetrievalConfig
from lpi_tpu_torch.continual.common import AdamState, adamw_update, clip_by_global_norm, \
    freeze, restore_in_place, staged_lrs
from lpi_tpu_torch.continual.keys import TaskKeys, exact_fp32, infer_task_ids
from lpi_tpu_torch.continual.mid import task_relation
from lpi_tpu_torch.data.retrieval import RetrievalEvalSet, RetrievalTrainSet
from lpi_tpu_torch.eval.retrieval import device_ranks, itm_eval
from lpi_tpu_torch.graphs import Graphed, captures
from lpi_tpu_torch.losses.clip_loss import alignment_loss, clip_loss, task_prompt_loss_masked
from lpi_tpu_torch.models.clip.slinet import SliNet, init_parameters
from lpi_tpu_torch.ops.kmeans import kmeans

POOL_KEYS = ("prompts", "ctx_pool")
PRETRAIN_CLIP = 1.0  # the global-norm clip of `pretrain`


class _Session(NamedTuple):
    task_id: torch.Tensor  # 0-d int64
    lr: torch.Tensor  # 0-d fp32
    trace: List[torch.Tensor]  # the momentum, one per pool leaf


class RetrievalLearner:
    """`init_params` is a state_dict (as `bridge.slinet_params_from_jax`
    returns) whose entries replace the seeded initial parameters;
    `generator` seeds those (default: `cfg.seed`). Runs on `device`, the
    card unless asked otherwise."""

    def __init__(self, cfg: RetrievalConfig, task_sim_matrix: Optional[np.ndarray] = None,
                 init_params: Optional[Mapping[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        model = SliNet(cfg)
        init_parameters(model, generator if generator is not None
                        else torch.Generator().manual_seed(cfg.seed))
        if init_params is not None:
            unexpected = model.load_state_dict(dict(init_params), strict=False).unexpected_keys
            if unexpected:
                raise KeyError(f"init_params has entries the model lacks: {unexpected[:5]}")
        self.model = model.to(self.device)
        self.pools, self.frozen = freeze(self.model, POOL_KEYS)
        T = cfg.total_sessions
        sim = np.eye(T, dtype=np.float32) if task_sim_matrix is None else task_sim_matrix
        self.task_relation = torch.tensor(task_relation(sim, cfg.lpi.task_sim_threshold),
                                          device=self.device)
        k, dim = cfg.num_key_clusters, cfg.clip.embed_dim
        self.visual_keys = TaskKeys.create(T, k, dim, device=self.device)
        self.textual_keys = TaskKeys.create(T, k, dim, device=self.device)
        self.session_results: Dict[int, dict] = {}
        self._session: Optional[_Session] = None
        self._graphs: Dict[tuple, Graphed] = {}  # captured steps by batch shapes

    def to_device(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """{'images': [B, H, W, 3] float32, 'token_ids': [B, 77] long} on
        the learner's device, from numpy arrays or tensors."""
        return {"images": torch.as_tensor(batch["images"]).to(self.device, torch.float32),
                "token_ids": torch.as_tensor(batch["token_ids"]).to(self.device, torch.long)}

    # ------------------------------------------------------------------
    def _losses(self, batch: Mapping[str, torch.Tensor], task_id):
        """-> (total, {base_loss, alignment_loss, task_loss}), each weighted;
        the last two only for "lpi" prompts. `task_id` is an int or a 0-d
        integer tensor on the device."""
        lpi = self.cfg.lpi
        img, txt, vis_p, txt_p, scale = self.model(batch["images"], batch["token_ids"], task_id)
        losses = {"base_loss": clip_loss(scale * img @ txt.T)}
        if lpi.prompt_type == "lpi" and lpi.layer_alignment:
            losses["alignment_loss"] = lpi.alignment_weight * alignment_loss(
                vis_p, txt_p, lpi.alignment_temperature)
        if lpi.prompt_type == "lpi" and lpi.task_alignment:
            vis_all, txt_all = self.model.all_task_prompts()
            T = vis_all.shape[0]
            losses["task_loss"] = lpi.task_loss_weight * task_prompt_loss_masked(
                vis_all.reshape(T, -1), txt_all.reshape(T, -1), self.task_relation, task_id,
                lpi.task_temperature)
        return sum(losses.values()), losses

    def _masks(self, task_id: torch.Tensor) -> List[torch.Tensor]:
        """Per pool parameter, the one-hot of `task_id` over its leading
        axis, shaped to broadcast."""
        return [(torch.arange(p.shape[0], device=p.device) == task_id).to(p.dtype)
                .reshape((-1,) + (1,) * (p.dim() - 1)) for p in self.pools.values()]

    def _sgd_step(self, batch: Mapping[str, torch.Tensor], task_id: torch.Tensor,
                  lr: torch.Tensor, trace: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One masked step in place on the pools and `trace` (the momentum).
        -> metrics, device tensors. Nothing reads a value back to the host,
        so it can be captured."""
        cfg = self.cfg
        params = list(self.pools.values())
        total, losses = self._losses(batch, task_id)
        # zero-shot CLIP's loss reads no pool leaf: no gradient at all
        grads = (torch.autograd.grad(total, params, allow_unused=True) if total.requires_grad
                 else [None] * len(params))
        with torch.no_grad():
            for p, g, mask, tr in zip(params, grads, self._masks(task_id), trace):
                g = torch.zeros_like(p) if g is None else g * mask
                tr.copy_((g + cfg.weight_decay * p) + cfg.momentum * tr)
                p.add_((-lr * tr) * mask)
        return {"total": total.detach(), **{k: v.detach() for k, v in losses.items()}}

    def _session_state(self) -> _Session:
        """The session inputs that every session's step reads (task id, lr,
        momentum), created once and reset in place by each
        `make_train_step`."""
        if self._session is None:
            self._session = _Session(torch.zeros((), dtype=torch.int64, device=self.device),
                                     torch.zeros((), dtype=torch.float32, device=self.device),
                                     [torch.zeros_like(p) for p in self.pools.values()])
        return self._session

    def make_train_step(self, task_id: int, steps_per_epoch: int, epochs: int,
                        eager: bool = False) -> Callable[[Mapping], Dict[str, torch.Tensor]]:
        """A session's masked step with a fresh momentum and the per-epoch
        cosine learning rate lrs[min(step // steps_per_epoch, epochs)], the
        rates staged on the device once: `step(batch)` -> metrics (device
        tensors). The task id, lr and momentum are written in place into the
        learner's one set of session inputs, so a new `make_train_step` ends
        the previous session. On the card the step is captured as one CUDA
        graph at its first batch of a new shape and replayed by every
        session; its metrics are static tensors that the next step
        overwrites. `eager=True` (or a CPU learner) runs it op by op."""
        sess = self._session_state()
        with torch.no_grad():
            for t in sess.trace:
                t.zero_()
        sess.task_id.fill_(task_id)
        lrs = staged_lrs(self.cfg.lr, epochs, self.device)
        count = itertools.count()
        capture = captures(self.device) and not eager

        def run(b):
            return self._sgd_step(b, sess.task_id, sess.lr, sess.trace)

        def step(batch):
            epoch = next(count) // max(steps_per_epoch, 1)
            sess.lr.copy_(lrs[min(epoch, epochs)])
            if not capture:
                return run(self.to_device(batch))
            key = tuple(tuple(np.shape(batch[k])) for k in ("images", "token_ids"))
            if key not in self._graphs:
                self._graphs[key] = Graphed(run, self.to_device(batch),
                                            state=[*self.pools.values(), *sess.trace])
            return self._graphs[key](batch)

        return step

    def pretrain(self, dataset: RetrievalTrainSet, steps: int,
                 lr: Optional[float] = None) -> Dict[str, float]:
        """Full-parameter contrastive training at task 0 (all three losses),
        the batches restarting with seed `cfg.seed + n` whenever a pass
        ends; then the frozen split again."""
        cfg = self.cfg
        lr = cfg.lr if lr is None else lr
        named = dict(self.model.named_parameters())
        params = list(named.values())
        for p in params:
            p.requires_grad_(True)
        state = AdamState.zeros(params)
        metrics = {}
        it = iter([])
        try:
            for n in range(steps):
                batch = next(it, None)
                if batch is None:
                    it = dataset.batches(cfg.batch_size, seed=cfg.seed + n)
                    batch = next(it)
                total, losses = self._losses(self.to_device(batch), 0)
                grads = torch.autograd.grad(total, params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
                adamw_update(params, clip_by_global_norm(grads, PRETRAIN_CLIP), state, lr, 0.0)
                total, losses = total.detach(), {k: v.detach() for k, v in losses.items()}
                metrics = {"total": total, **losses}
        finally:
            self.pools, self.frozen = freeze(self.model, POOL_KEYS)
        return {k: float(v) for k, v in metrics.items()}

    def train_session(self, dataset: RetrievalTrainSet,
                      epochs: Optional[int] = None) -> Dict[str, float]:
        """Train the session of `dataset.task_index`, then set its task keys."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        step = self.make_train_step(dataset.task_index,
                                    max(len(dataset) // cfg.batch_size, 1), epochs)
        metrics = {}
        t0 = time.perf_counter()
        steps = 0
        for epoch in range(epochs):
            for batch in dataset.batches(cfg.batch_size, seed=cfg.seed + epoch):
                metrics = step(batch)
                steps += 1
        out = {k: float(v) for k, v in metrics.items()}  # the fetch waits for the device
        out["samples_per_sec"] = steps * cfg.batch_size / max(time.perf_counter() - t0, 1e-9)
        self.cluster_task(dataset)
        return out

    # ------------------------------------------------------------------
    def extract_visual(self, images) -> torch.Tensor:
        """Frozen promptless image features for the task keys, exact fp32
        (TF32 off)."""
        images = torch.as_tensor(images).to(self.device, torch.float32)
        with torch.no_grad(), exact_fp32():
            return self.model.extract_visual(images)

    def extract_textual(self, token_ids) -> torch.Tensor:
        """Frozen promptless text features for the task keys, exact fp32."""
        token_ids = torch.as_tensor(token_ids).to(self.device, torch.long)
        with torch.no_grad(), exact_fp32():
            return self.model.extract_textual(token_ids)

    def cluster_task(self, dataset: RetrievalTrainSet) -> None:
        """k-means task keys per modality over the session's frozen
        features, each seeded from a generator at 0 (the JAX package uses
        `PRNGKey(0)` for both)."""
        cfg = self.cfg
        vis, txt = [], []
        for batch in dataset.batches(cfg.batch_size, seed=0, drop_remainder=False):
            vis.append(self.extract_visual(batch["images"]))
            txt.append(self.extract_textual(batch["token_ids"]))
        k = cfg.num_key_clusters
        vc, _ = kmeans(torch.cat(vis)[:len(dataset)], torch.Generator().manual_seed(0), k=k)
        tc, _ = kmeans(torch.cat(txt)[:len(dataset)], torch.Generator().manual_seed(0), k=k)
        self.visual_keys = self.visual_keys.update(dataset.task_index, vc)
        self.textual_keys = self.textual_keys.update(dataset.task_index, tc)

    # ------------------------------------------------------------------
    def evaluate(self, eval_set: RetrievalEvalSet, num_tasks: int) -> dict:
        """Cumulative retrieval evaluation with task-ID inference: {'i2t',
        't2i': {task: [R@1, R@5, R@10]}, 'summary', 'task_id_accuracy':
        {'visual', 'textual'}}. The zero-shot "clip" type ranks the frozen
        features, every sample at task 0."""
        cfg = self.cfg
        zero_shot = cfg.lpi.prompt_type == "clip"

        def encode(batches, dtype, extract, keys, encode_tasks):
            feats, sel = [], []
            for x, n in batches:
                x = torch.as_tensor(x).to(self.device, dtype)
                frozen = extract(x)
                if zero_shot:
                    feats.append(frozen[:n])
                    sel.append(torch.zeros(n, dtype=torch.long, device=self.device))
                    continue
                ids = infer_task_ids(frozen, keys)
                with torch.no_grad():
                    feats.append(encode_tasks(x, ids)[:n])
                sel.append(ids[:n])
            return torch.cat(feats), torch.cat(sel).cpu().numpy()

        img_feats, img_sel = encode(eval_set.image_batches(cfg.batch_size), torch.float32,
                                    self.extract_visual, self.visual_keys,
                                    self.model.encode_image_tasks)
        txt_feats, txt_sel = encode(eval_set.text_batches(cfg.eval_text_chunk), torch.long,
                                    self.extract_textual, self.textual_keys,
                                    self.model.encode_text_tasks)
        ranks = device_ranks(img_feats, txt_feats, eval_set.txt2img, eval_set.img2txt)
        res = itm_eval(None, None, eval_set.txt2img, eval_set.img2txt,
                       eval_set.image_categories, eval_set.text_categories, num_tasks,
                       ranks=ranks)
        res["task_id_accuracy"] = {
            "visual": float(np.mean(img_sel == eval_set.image_categories)),
            "textual": float(np.mean(txt_sel == eval_set.text_categories)),
        }
        return res

    def restore(self, checkpointer, session: Optional[int] = None) -> int:
        """Load the frozen base and a session's pools and task keys (the
        latest session by default) from a `SessionCheckpointer`, in place;
        -> the session restored. A checkpoint whose names or shapes differ
        from the model's is refused, naming the first mismatch."""
        session, state = restore_in_place(checkpointer, session, {**self.frozen, **self.pools})
        T, k = self.cfg.total_sessions, self.cfg.num_key_clusters
        if "visual_keys" in state:
            self.visual_keys = TaskKeys.from_state(state["visual_keys"], T, k, self.device)
        if "textual_keys" in state:
            self.textual_keys = TaskKeys.from_state(state["textual_keys"], T, k, self.device)
        return session

    def run(self, train_sets, eval_sets, epochs: Optional[int] = None) -> dict:
        """The full continual loop: each session trained, then evaluated
        over the sessions seen so far."""
        for i, train_set in enumerate(train_sets):
            self.train_session(train_set, epochs=epochs)
            self.session_results[i] = self.evaluate(eval_sets[i], num_tasks=i + 1)
        return self.session_results
