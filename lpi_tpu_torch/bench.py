"""The port's benchmark and quality gates (counterpart of `bench.py`).

* `bench_retrieval`: samples/s of the full-width continual-retrieval train
  step (SliNet: CLIP ViT-B/16 at 224 px with LPI prompts, batch 64, bf16),
  the reference's headline `retrieval_train_samples_per_sec_per_chip`:
  `bench.py:bench_retrieval`'s inputs, one warm step, 50 dependent steps,
  one host fetch.
* `bench_grounding`: samples/s of the full-width continual-grounding train
  step (GLIP-T + LPI at 448 px, batch 4, bf16), `bench.py:bench_grounding`:
  one warm step, 10 dependent steps, one host fetch, first with the seeded
  offset convs (offsets near 0), then with `honest_offsets` (offsets of a
  trained model's size) through the same captured step; the reference's
  `grounding_train_samples_per_sec_per_chip` (honest) and
  `grounding_train_samples_per_sec_zero_offsets`.
* `bench_quality_retrieval`: the retrieval quality gate, `bench.py`'s
  `bench_quality` leg: a tiny CLIP (32 px, patch 8, width 64, 3 layers a
  tower, fp32) pretrained with all parameters for 600 steps on the mixed
  correlated synthetic set, then 3 sessions of prompts, each evaluated over
  the sessions seen so far; txt R@1, img R@1 and the i2t P@1 average >= 50,
  both task-ID accuracies >= 0.8, i2t forgetting <= 10 (`RETRIEVAL_BARS`).
* `bench_quality_grounding`: the grounding gate, `gate_grounding_config`
  and `bench_quality_grounding`: a tiny GLIP-T + LPI (channels 16,
  GroupNorm FPN, 64 px) pretrained with all parameters on a mixed set of
  the synthetic grounding tasks, then trained one task at a time with only
  that task's prompts, and evaluated after every task over the tasks seen
  so far: RefExp P@1 and P@5 (GIoU >= 0.5), task-ID accuracy and
  forgetting (a task's best P@1 at an earlier checkpoint minus its final
  P@1, averaged over the tasks before the last); bars `QUALITY_BARS`.

The gates run under PyTorch's deterministic algorithms (`deterministic`),
as XLA's programs are on the TPU: with the card's default atomics in its
backward passes the grounding task-ID accuracy of one recipe moved between
0.639 and 0.917 from run to run on an H100, so a bar on one run would check
luck, not the port (`scripts/torch_gate_spread.py`).

    python -m lpi_tpu_torch.bench       # on the card: one JSON line

On the card the train steps run captured (`lpi_tpu_torch.graphs`), as the
JAX package's run jitted.

    from lpi_tpu_torch.bench import bench_quality_grounding
    bench_quality_grounding()                 # on the card, deform_impl "pallas"
    bench_quality_grounding(deform_impl="fused")
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from lpi_tpu_torch.config import (ATSSConfig, BertConfig, CLIPConfig, DyHeadConfig,
                                  GroundingConfig, LPIPromptConfig, RetrievalConfig,
                                  SwinConfig)

QUALITY_BARS = {"grounding_p1": 30.0, "grounding_task_id_acc": 0.8,
                "grounding_forgetting": 15.0}
RETRIEVAL_BARS = {"r1": 50.0, "task_id": 0.8, "forgetting": 10.0}
RETRIEVAL_GATE_TASKS = 3
SOT, EOT = 49406, 49407  # CLIP's start- and end-of-text ids (`bench.py:bench_retrieval`)


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


def retrieval_inputs(cfg: RetrievalConfig) -> dict:
    """The retrieval bench's batch (`bench.py:bench_retrieval`): images
    N(0, 1) and token ids U[1, 49000) from `RandomState(0)`, SOT first and
    EOT last."""
    rng = np.random.RandomState(0)
    res, batch = cfg.clip.image_resolution, cfg.batch_size
    images = rng.randn(batch, res, res, 3).astype(np.float32)
    ids = rng.randint(1, 49000, size=(batch, cfg.clip.context_length)).astype(np.int32)
    ids[:, 0] = SOT
    ids[:, -1] = EOT
    return {"images": images, "token_ids": ids}


def bench_retrieval(device="cuda", cfg: Optional[RetrievalConfig] = None,
                    iters: int = 50) -> float:
    """Samples/s of the masked train step at task 0 on `cfg` (default
    `RetrievalConfig()`: full ViT-B/16 + LPI prompts, batch 64, bf16) and
    `retrieval_inputs`: one warm step, `iters` dependent steps, then one
    host fetch (the barrier)."""
    from lpi_tpu_torch.continual.learner import RetrievalLearner

    cfg = RetrievalConfig() if cfg is None else cfg
    learner = RetrievalLearner(cfg, device=device)
    step = learner.make_train_step(task_id=0, steps_per_epoch=100, epochs=cfg.epochs)
    b = learner.to_device(retrieval_inputs(cfg))
    float(step(b)["total"])
    t0 = time.perf_counter()
    for _ in range(iters):
        metrics = step(b)
    float(metrics["total"])  # waits for the whole dependent chain
    return cfg.batch_size * iters / (time.perf_counter() - t0)


def honest_offsets(model) -> None:
    """Give the head's offset convs offsets of a trained model's size (about
    +-1-2 px), as `bench.py:365-384` means to: every offset conv's kernel
    x30, its bias zero but for `bias[:18]` ~ N(0, 1), drawn from one
    `RandomState(7)` conv after conv in the JAX package's order (a jitted
    init sorts its keys: tower0, tower1, tower10, tower2, ...). In place,
    so a step or request captured before reads the new values. (`bench.py`
    applies its loop to the flat split of the parameters, whose keys are
    whole paths, so there it matches no key and both of its timings run
    the seeded offsets.)"""
    rng = np.random.RandomState(7)
    towers = model.head.towers
    with torch.no_grad():
        for i in sorted(range(len(towers)), key=lambda i: f"tower{i}"):
            conv = towers[i].offset
            conv.weight.mul_(30.0)
            bias = np.zeros(conv.bias.shape, np.float32)
            bias[:18] = rng.randn(18) * 1.0
            conv.bias.copy_(torch.from_numpy(bias))


def bench_grounding(device="cuda", cfg: Optional[GroundingConfig] = None,
                    iters: int = 10) -> dict:
    """Samples/s of the masked grounding step at task 0 on `cfg` (default
    `GroundingConfig(image_size=448, batch_size=4)`: full GLIP-T + LPI,
    bf16) and `synthetic_grounding_task(0, batch, ...)`'s batch: one warm
    step, `iters` dependent steps, one host fetch; first with the seeded
    offset convs, then after `honest_offsets` through the same step (on
    the card, the same capture). -> {"honest_offsets": sps,
    "zero_offsets": sps}."""
    from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
    from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
    from lpi_tpu_torch.data.grounding import synthetic_grounding_task

    cfg = GroundingConfig(image_size=448, batch_size=4) if cfg is None else cfg
    tok = BertTokenizer(max_len=cfg.bert.max_query_len, vocab_size=cfg.bert.vocab_size)
    ds = synthetic_grounding_task(0, cfg.batch_size, cfg.image_size, tok,
                                  max_boxes=cfg.max_boxes)
    learner = GroundingLearner(cfg, device=device)
    step = learner.make_step(0, steps_per_epoch=10, epochs=cfg.epochs_per_task)
    b = learner.to_device(next(ds.batches(cfg.batch_size)))

    def timed():
        float(step(b)["total"])
        t0 = time.perf_counter()
        for _ in range(iters):
            metrics = step(b)
        float(metrics["total"])  # waits for the whole dependent chain
        return cfg.batch_size * iters / (time.perf_counter() - t0)

    zero = timed()
    honest_offsets(learner.model)
    return {"honest_offsets": timed(), "zero_offsets": zero}


def gate_retrieval_config() -> RetrievalConfig:
    """The retrieval gate's tiny config (`bench.py:180-189`): CLIP at 32 px,
    patch 8, width 64, 3 layers a tower, embed 32, 4 context tokens; LPI
    prompts of length 4, depth 3, rank 2; 4 epochs a session, batch 8,
    lr 0.05, k = 2 task-key clusters, fp32."""
    return RetrievalConfig(
        clip=CLIPConfig(
            image_resolution=32, patch_size=8, vision_width=64,
            vision_layers=3, vision_heads=4, text_width=64, text_layers=3,
            text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
            n_ctx=4),
        lpi=LPIPromptConfig(prompt_length=4, prompt_depth=3, prompt_rank=2),
        total_sessions=RETRIEVAL_GATE_TASKS, epochs=4, batch_size=8, lr=0.05,
        visual_dim=64, textual_dim=64, num_key_clusters=2, dtype="float32")


def bench_quality_retrieval(device="cuda", pretrain_steps: int = 600,
                            epochs: Optional[int] = None) -> dict:
    """The retrieval gate's run with deterministic algorithms: pretrain
    `pretrain_steps` at lr 1e-3 on `synthetic_correlated_pretrain`, then
    3 sessions of `synthetic_correlated_session` (24 samples), each
    evaluated on `synthetic_correlated_eval` over the sessions so far. Runs
    on `device`, the card unless asked otherwise. -> task_id_acc_visual,
    task_id_acc_textual, txt_r1, img_r1, i2t_p1_average, i2t_forgetting,
    rounded as `bench.py` rounds them."""
    with deterministic():
        return _retrieval_gate_run(device, pretrain_steps, epochs)


def _retrieval_gate_run(device, pretrain_steps, epochs) -> dict:
    from lpi_tpu_torch.continual.learner import RetrievalLearner
    from lpi_tpu_torch.data.retrieval import (synthetic_correlated_eval,
                                              synthetic_correlated_pretrain,
                                              synthetic_correlated_session)
    from lpi_tpu_torch.data.tokenizer import ClipTokenizer
    from lpi_tpu_torch.eval.retrieval import aggregate_results

    n_tasks = RETRIEVAL_GATE_TASKS
    cfg = gate_retrieval_config()
    tok = ClipTokenizer()
    learner = RetrievalLearner(cfg, task_sim_matrix=np.eye(n_tasks), device=device)
    learner.pretrain(synthetic_correlated_pretrain(n_tasks, 24, 32, tok, cfg.clip.n_ctx),
                     steps=pretrain_steps, lr=1e-3)
    results = {}
    for t in range(n_tasks):
        learner.train_session(synthetic_correlated_session(t, 24, 32, tok, cfg.clip.n_ctx),
                              epochs=epochs)
        ev = synthetic_correlated_eval(t + 1, 8, 32, tok, cfg.clip.n_ctx)
        results[t] = learner.evaluate(ev, num_tasks=t + 1)
    final = results[n_tasks - 1]
    agg = aggregate_results(results, direction="i2t", k_index=0)
    return {
        "task_id_acc_visual": round(final["task_id_accuracy"]["visual"], 3),
        "task_id_acc_textual": round(final["task_id_accuracy"]["textual"], 3),
        "txt_r1": round(float(final["summary"]["txt_r1"]), 1),
        "img_r1": round(float(final["summary"]["img_r1"]), 1),
        "i2t_p1_average": round(agg["average"], 1),
        "i2t_forgetting": round(agg["forgetting"], 1),
    }


def retrieval_quality_ok(result: dict) -> bool:
    """Whether a run meets the retrieval gate's bars."""
    b = RETRIEVAL_BARS
    return (result["txt_r1"] >= b["r1"] and result["img_r1"] >= b["r1"]
            and result["i2t_p1_average"] >= b["r1"]
            and result["task_id_acc_visual"] >= b["task_id"]
            and result["task_id_acc_textual"] >= b["task_id"]
            and result["i2t_forgetting"] <= b["forgetting"])


def main() -> int:
    """One JSON line with the reference's keys: the retrieval step's
    samples/s, the grounding step's (honest and zero offsets), and
    `quality` (both gates, their bars, `quality_ok`), beside the card's
    name. Exits 1 without a card."""
    if not torch.cuda.is_available():
        print("lpi_tpu_torch.bench: no CUDA device", file=sys.stderr)
        return 1
    sps = bench_retrieval()
    grounding_sps = bench_grounding()
    torch.cuda.empty_cache()
    quality = bench_quality_retrieval()
    grounding = bench_quality_grounding()
    quality["quality_bars"] = {**RETRIEVAL_BARS, "grounding_p1": QUALITY_BARS["grounding_p1"],
                               "grounding_task_id": QUALITY_BARS["grounding_task_id_acc"],
                               "grounding_forgetting": QUALITY_BARS["grounding_forgetting"]}
    quality["quality_ok"] = retrieval_quality_ok(quality) and quality_ok(grounding)
    quality.update(grounding)
    print(json.dumps({"metric": "retrieval_train_samples_per_sec_per_chip",
                      "value": round(sps, 2), "unit": "samples/s",
                      "grounding_train_samples_per_sec_per_chip":
                          round(grounding_sps["honest_offsets"], 2),
                      "grounding_train_samples_per_sec_zero_offsets":
                          round(grounding_sps["zero_offsets"], 2),
                      "device": torch.cuda.get_device_name(0), "quality": quality,
                      "quality_ok": quality["quality_ok"]}), flush=True)
    return 0 if quality["quality_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
