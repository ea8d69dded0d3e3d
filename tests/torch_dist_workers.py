"""Functions the multi-process tests run on each rank of a gloo group
(`lpi_tpu_torch.dryrun.run_world`). They live outside the test files, and
import only torch, numpy and the port, so that a spawned rank imports them
without `tests/conftest.py` and without JAX."""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist


def modules_loaded() -> dict:
    """Which of JAX and the JAX package a spawned rank holds, after it has
    imported the port's distributed modules."""
    import lpi_tpu_torch.core.dist  # noqa: F401
    import lpi_tpu_torch.core.mesh  # noqa: F401
    import lpi_tpu_torch.core.pipeline  # noqa: F401
    import lpi_tpu_torch.dryrun  # noqa: F401

    return {name: name in sys.modules for name in ("jax", "lpi_tpu")}


def helpers(rows: int = 2) -> dict:
    """The helpers of `core.dist` on a (2, 2) mesh: the object gather, the
    dict reduction, and `gather_rows`, `global_mean`, `average_gradients`,
    `copy_to` and `reduce_from` on this rank's `data` and `model`
    subgroups, forward and backward. Rank r's input is `r + arange`, its
    loss weight `w = 1 + r + arange` (a different loss on every rank)."""
    from lpi_tpu_torch.config import MeshConfig
    from lpi_tpu_torch.core import dist as d
    from lpi_tpu_torch.core.mesh import make_mesh

    mesh = make_mesh(MeshConfig(data_parallel=2, model_parallel=2))
    r = dist.get_rank()
    out = {"rank": r, "coords": (mesh.data_rank, mesh.model_rank),
           "objects": d.all_gather_objects({"rank": r}),
           "reduced": d.reduce_dict({"a": float(r), "b": 2.0}),
           "summed": d.reduce_dict({"a": float(r)}, average=False)}
    d.synchronize()
    x = (r + torch.arange(rows * 3, dtype=torch.float32).reshape(rows, 3)).requires_grad_()
    w = 1.0 + r + torch.arange(2 * rows * 3, dtype=torch.float32).reshape(2 * rows, 3)
    gathered = d.gather_rows(x, mesh.data_group)
    (grad,) = torch.autograd.grad((w * gathered).sum(), x)
    out.update(x=x.detach().numpy(), w=w.numpy(), gathered=gathered.detach().numpy(),
               grad=grad.numpy())
    s = (x * w[:rows]).sum()
    m = d.global_mean(s, mesh.data_group)
    (gm,) = torch.autograd.grad(m, x)
    out.update(local_sum=float(s.detach()), mean=float(m.detach()), mean_grad=gm.numpy())
    out["averaged"] = [None if g is None else g.numpy() for g in d.average_gradients(
        [x.detach() * 2, None, torch.tensor([float(r)], dtype=torch.float64)],
        mesh.data_group)]
    out["all_sum"] = float(d.all_sum(torch.tensor(float(r)), mesh.data_group))
    c = d.copy_to(x, mesh.model_group)
    (gc,) = torch.autograd.grad((c * w[:rows]).sum(), x)
    red = d.reduce_from(x * 1.0, mesh.model_group)
    (gr,) = torch.autograd.grad((red * w[:rows]).sum(), x)
    out.update(copy=c.detach().numpy(), copy_grad=gc.numpy(), reduced_x=red.detach().numpy(),
               reduce_grad=gr.numpy())
    return out


def global_loss(img: np.ndarray, txt: np.ndarray, scale: float) -> dict:
    """`global_clip_loss` over a `data` group of every rank, this rank on its
    rows of the global features: the loss and its gradients with respect
    to its rows of both towers."""
    from lpi_tpu_torch.config import MeshConfig
    from lpi_tpu_torch.core.mesh import make_mesh, shard_rows
    from lpi_tpu_torch.losses.clip_loss import global_clip_loss

    mesh = make_mesh(MeshConfig())
    i = torch.tensor(shard_rows(img, mesh), requires_grad=True)
    t = torch.tensor(shard_rows(txt, mesh), requires_grad=True)
    loss = global_clip_loss(i, t, torch.tensor(scale), mesh.data_group)
    gi, gt = torch.autograd.grad(loss, (i, t))
    return {"loss": float(loss.detach()), "img_grad": gi.numpy(), "txt_grad": gt.numpy()}


def grounding_dp(cfg, steps: int) -> dict:
    """`dryrun.grounding_leg` over every rank as data-parallel, twice: as
    the port runs it ("dp"), and with the planted fault ("fault"): the
    learner calls the ATSS losses without the `data` group, so each rank
    divides by its own positives and centerness sum (no sum over the
    ranks). Also this rank's own positives at each step ("local_pos")."""
    from lpi_tpu_torch import dryrun
    from lpi_tpu_torch.continual import grounding_learner as gl

    real = gl.atss_losses
    out = {}
    for kind in ("dp", "fault"):
        local_pos = []

        def atss(*a, group=None, **kw):
            local = real(*a, **kw)
            local_pos.append(float(local["num_pos"]))
            return local if kind == "fault" else real(*a, group=group, **kw)

        gl.atss_losses = atss
        try:
            out[kind] = dryrun.grounding_leg(cfg, dist.get_world_size(), steps=steps)
        finally:
            gl.atss_losses = real
        out[kind]["local_pos"] = local_pos
    return out


class _Jittered:
    """A grounding set whose batches' images carry seeded relative noise of
    size `eps`."""

    def __init__(self, task, eps: float):
        self.task, self.eps = task, eps

    def batches(self, batch_size, seed=0, **kw):
        rng = np.random.RandomState(seed)
        for b in self.task.batches(batch_size, seed=seed, **kw):
            im = np.asarray(b["images"], np.float32)
            yield {**b, "images": (im * (1 + self.eps * rng.randn(*im.shape))).astype(np.float32)}


def _pretrain_step(module, update: str, learner, dataset) -> dict:
    """One `learner.pretrain` step. -> its losses and the (clipped)
    gradients that `module.<update>`, its AdamW, receives, by name."""
    seen = []
    real = getattr(module, update)

    def spy(params, grads, *a, **kw):
        seen.append([g.detach().cpu().numpy().copy() for g in grads])
        return real(params, grads, *a, **kw)

    names = [n for n, _ in learner.model.named_parameters()]
    setattr(module, update, spy)
    try:
        metrics = learner.pretrain(dataset, steps=1)
    finally:
        setattr(module, update, real)
    return {"metrics": metrics, "grads": dict(zip(names, seen[0], strict=True))}


def _placed(dp):
    from lpi_tpu_torch.config import MeshConfig
    from lpi_tpu_torch.core.mesh import make_mesh

    mesh = None if dp is None else make_mesh(MeshConfig(data_parallel=dp))
    return mesh, "cpu" if mesh is None else mesh.device


def grounding_pretrain(gcfg, dp=None, jitter: float = 0.0) -> dict:
    """One grounding `pretrain` step over a (dp, 1) mesh, or (dp None) in
    one process, on the dry run's set of task 0, its images jittered by
    `jitter` (relative). -> `_pretrain_step`'s losses and gradients."""
    from lpi_tpu_torch import dryrun
    from lpi_tpu_torch.continual import grounding_learner as gl

    mesh, device = _placed(dp)
    task = dryrun.tiny_grounding_set(gcfg, 0)
    return _pretrain_step(gl, "adamw_apply", gl.GroundingLearner(gcfg, device=device, mesh=mesh),
                          _Jittered(task, jitter) if jitter else task)


def rest_of_the_learners(rcfg, gcfg, dp) -> dict:
    """The learners' other mesh paths, over a (dp, 1) mesh, or (dp None) in
    one process on the CPU: one `pretrain` step of each learner (every
    parameter, the gradients averaged over `data`), then, on a fresh
    grounding learner, `cluster_task` (`extract_features` over this rank's
    rows, gathered) and `evaluate` (the postprocess outputs gathered:
    boxes, scores and the bool `valid`) on the dry run's set of task 0,
    with the detections that `evaluate` scores. `pretrain` gives its
    losses and the clipped gradients that its AdamW update receives: the
    parameters after AdamW's first step would hold the summation order's
    rounding of the gradients near 0 at g / (|g| + eps), in full."""
    from lpi_tpu_torch import dryrun
    from lpi_tpu_torch.continual import grounding_learner as gl
    from lpi_tpu_torch.continual import learner as rl

    mesh, device = _placed(dp)
    out = {"retrieval": _pretrain_step(rl, "adamw_update",
                                       rl.RetrievalLearner(rcfg, device=device, mesh=mesh),
                                       dryrun.tiny_retrieval_set(rcfg)),
           "grounding": grounding_pretrain(gcfg, dp)}
    task = dryrun.tiny_grounding_set(gcfg, 0)
    # every candidate passes the score threshold, so that the untrained
    # tiny model's detections are not empty
    ecfg = dataclasses.replace(gcfg, atss=dataclasses.replace(gcfg.atss, inference_thresh=0.0))
    grounding = gl.GroundingLearner(ecfg, device=device, mesh=mesh)
    grounding.cluster_task(task)
    detections = []

    class Recorder(gl.RefExpEvaluator):
        def update(self, **kw):
            detections.append({k: np.array(v) for k, v in kw.items()})
            return super().update(**kw)

    real = gl.RefExpEvaluator
    gl.RefExpEvaluator = Recorder
    try:
        out["eval"] = grounding.evaluate({0: task})
    finally:
        gl.RefExpEvaluator = real
    out.update(keys=grounding.keys.centers.cpu().numpy(), detections=detections)
    return out


def tensor_parallel(rcfg, r_init, gcfg, gcfg_fused) -> dict:
    """The (2, 2) legs on 4 ranks: a retrieval session (`retrieval_leg`), two
    grounding steps and one with early fusion (`grounding_leg`: its head's
    BERT layers shard `attention_output` alone, by rows, as the JAX rules
    do)."""
    from lpi_tpu_torch import dryrun

    return {"retrieval": dryrun.retrieval_leg(rcfg, 2, 2, init_params=r_init),
            "grounding": dryrun.grounding_leg(gcfg, 2, 2, steps=2),
            "early_fused": dryrun.grounding_leg(gcfg_fused, 2, 2, steps=1)}


def failing() -> int:
    """Rank 1 raises; rank 0 returns."""
    if dist.get_rank() == 1:
        raise ValueError("planted failure of rank 1")
    return 0

