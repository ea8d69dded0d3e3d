"""The grounding quality gate on the port (counterpart of `bench.py`'s
`gate_grounding_config` and `bench_quality_grounding`).

A tiny GLIP-T + LPI (channels 16, GroupNorm FPN, 64 px) is pretrained with
all parameters on a mixed set of the synthetic grounding tasks (the role
GLIP-T(A) pretraining plays for the real recipe), then trained one task at
a time with only that task's prompts, and evaluated after every task over
the tasks seen so far: RefExp P@1 and P@5 (GIoU >= 0.5), task-ID accuracy
and forgetting (a task's best P@1 at an earlier checkpoint minus its final
P@1, averaged over the tasks before the last). The bars the gate holds a
run to are `QUALITY_BARS`.

A run uses PyTorch's deterministic algorithms (`deterministic`), as XLA's
programs are on the TPU: with the card's default atomics in its backward
passes the task-ID accuracy of one recipe moved between 0.639 and 0.917
from run to run on an H100, so a bar on one run would check luck, not the
port (`scripts/torch_gate_spread.py`).

    from lpi_tpu_torch.bench import bench_quality_grounding
    bench_quality_grounding()                 # on the card, deform_impl "pallas"
    bench_quality_grounding(deform_impl="fused")
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from lpi_tpu_torch.config import (ATSSConfig, BertConfig, DyHeadConfig, GroundingConfig,
                                  LPIPromptConfig, SwinConfig)

QUALITY_BARS = {"grounding_p1": 30.0, "grounding_task_id_acc": 0.8,
                "grounding_forgetting": 15.0}


def gate_grounding_config(n_tasks: int = 3) -> GroundingConfig:
    """The gate's tiny grounding config: channels 16, the GroupNorm FPN
    (tiny from-scratch pretraining needs the normalisation), 8x-stride
    anchors, k = 5 task-key clusters, fp32."""
    return GroundingConfig(
        swin=SwinConfig(patch_size=4, embed_dim=8, depths=(2, 2, 6, 2),
                        num_heads=(1, 2, 2, 2), window_size=4),
        bert=BertConfig(vocab_size=512, hidden_size=16, num_layers=12, num_heads=2,
                        intermediate_size=32, max_position_embeddings=32, max_query_len=16),
        dyhead=DyHeadConfig(num_convs=2, channels=16, max_tokens=16),
        atss=ATSSConfig(anchor_sizes=(32, 64, 128, 256, 512),
                        anchor_strides=(4, 8, 16, 32, 64), pre_nms_top_n=50,
                        fpn_post_nms_top_n=10),
        lpi=LPIPromptConfig(prompt_length=4, prompt_depth=9, prompt_rank=2,
                            interact_rank=2, interact_depth=9),
        fpn_use_gn=True,
        total_tasks=n_tasks, epochs_per_task=2, batch_size=4,
        max_boxes=4, image_size=64, num_key_clusters=5, dtype="float32",
        lr=0.003, fused_scan_unroll=99)


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms inside the block (cuDNN's
    deterministic convolutions without autotuning, a warning for any op
    that has no deterministic form), restored after it. cuBLAS also needs
    `CUBLAS_WORKSPACE_CONFIG` before its first use in the process; it is set
    here if unset, which covers a fresh process."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:]


def bench_quality_grounding(device="cuda", deform_impl: str = "pallas",
                            pretrain_steps: int = 242, epochs: int = 8,
                            n_tasks: int = 3) -> dict:
    """The gate's run: pretrain, then `n_tasks` tasks of `epochs` epochs,
    each followed by an evaluation over the tasks seen so far, with
    deterministic algorithms. Runs on `device`, the card unless asked
    otherwise. -> grounding_p1, grounding_p5 (percent),
    grounding_task_id_acc, grounding_forgetting (P@1 points), rounded as
    `bench.py` rounds them."""
    with deterministic():
        return _gate_run(device, deform_impl, pretrain_steps, epochs, n_tasks)


def _gate_run(device, deform_impl, pretrain_steps, epochs, n_tasks) -> dict:
    from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
    from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
    from lpi_tpu_torch.data.grounding import GroundingTaskSet, synthetic_grounding_task

    cfg = gate_grounding_config(n_tasks)
    cfg = dataclasses.replace(cfg, dyhead=dataclasses.replace(cfg.dyhead,
                                                              deform_impl=deform_impl))
    tok = BertTokenizer(max_len=16, vocab_size=512)
    tasks = {t: synthetic_grounding_task(t, 24, cfg.image_size, tok) for t in range(n_tasks)}
    learner = GroundingLearner(cfg, device=device)
    mixed = GroundingTaskSet.concat([
        synthetic_grounding_task(t, 16, cfg.image_size, tok, seed=5) for t in range(n_tasks)])
    learner.pretrain(mixed, steps=pretrain_steps, lr=cfg.lr)
    p1_history = {}  # checkpoint t -> {task s: P@1 on task s}
    res = None
    for t in range(n_tasks):
        learner.train_task(tasks[t], epochs=epochs)
        res = learner.evaluate({s: tasks[s] for s in range(t + 1)})
        p1_history[t] = {s: float(res["per_task"][s][0]) for s in range(t + 1)}
    final = p1_history[n_tasks - 1]
    drops = [max(p1_history[t][s] for t in range(s, n_tasks - 1)) - final[s]
             for s in range(n_tasks - 1)]
    return {
        "grounding_p1": round(float(res["overall"][0]), 1),
        "grounding_p5": round(float(res["overall"][1]), 1),
        "grounding_task_id_acc": round(float(res["task_id_accuracy"]), 3),
        "grounding_forgetting": round(float(np.mean(drops)), 1),
    }


def quality_ok(result: dict) -> bool:
    """Whether a run meets the gate's bars."""
    return (result["grounding_p1"] >= QUALITY_BARS["grounding_p1"]
            and result["grounding_task_id_acc"] >= QUALITY_BARS["grounding_task_id_acc"]
            and result["grounding_forgetting"] <= QUALITY_BARS["grounding_forgetting"])
