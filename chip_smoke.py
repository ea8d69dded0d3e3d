"""Quickest proof that the PyTorch port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and `nvcc` for sm_90a. Phases (any failure exits
non-zero):

1. build every CUDA kernel of the port from `lpi_tpu_torch/csrc/`;
2. hold each forward kernel against its plain PyTorch version on the card at
   every shape the 448 px grounding predictor (batch 1) and train step
   (batch 4) give it, in fp32 and bf16, with one launch per call and two
   calls equal bit for bit, time both (CUDA graphs; the kernel's median of
   20 replays, the plain version's of 3) and give
   each level's share of the bound (the rows of h that carry weight);
   2b. the same for the two backward kernels at the train step's shapes,
       with one launch per call, two calls equal bit for bit and each
       level's share of the bound;
3. drive the full-width GLIP-T + LPI grounding predictor
   (`lpi_tpu_torch.serve.predictor.GroundingPredictor`, `GroundingConfig()`
   defaults, seeded random weights and task keys) through 1 + 5 requests
   eagerly and 1 + 5 captured (its task-id pass and forward replayed as
   CUDA graphs), with the kernels' launch counters checked, one request of
   each profiled with its deform launches read from the kernel names, the
   median latency of each, and equal task ids and detections;
4. run the same model in fp32 on the card and on the CPU (plain versions)
   and compare the head outputs and the inferred task id (the head's first
   2 of 6 towers on both sides, `cpu_depth_cut`);
5. drive the full-width continual-grounding train step
   (`lpi_tpu_torch.continual.grounding_learner.GroundingLearner`, batch 4,
   448 px, bf16, task 1, offsets of a trained model's size from
   `lpi_tpu_torch.bench.honest_offsets`) for 1 + 5 steps eagerly and 1 +
   5 captured from the same starting state, under deterministic
   algorithms: the launch counters, every metric and pool leaf captured
   against eager in bits (else the repo's bar, the largest error printed),
   the frozen parameters and the other tasks' pool rows unchanged, and per
   mode the median step, samples/s, a profiled step's busy share and
   kernels, peak memory; the replayed step's deform launches read from
   the kernel names (54 / 24 / 54 / 24);
6. compute one fp32 `_losses` and its pool gradients at batch 1 on the card
   and on the CPU from the same seeded weights (the head cut to 2 towers on
   both sides, `cpu_depth_cut`) and compare them, the
   concatenated gradient and each leaf's (a leaf over the bar read again
   with every module's output on the CPU set to the card's, which puts
   both backwards on the same side of the network's kinks).

The fused deformable conv (`deform_impl="fused"`) and the quality gate:

   2c. hold the fused forward and backward kernels (with and without d W)
       against their plain versions at every shape of the 448 px path
       (batch 1 and 4, 256 channels) and of the gate's config (16
       channels, 64 px), with one launch counted per call and two calls of
       each equal bit for bit, and time them beside their bounds;
   2d. hold the bilinear upsample's forward and backward kernels
       (`ops/resize_bilinear.py`) against their plain versions on the card
       at the b16 train step's four levels (28->56, 14->28, 7->14, 4->7,
       256 channels) and at a request's odd size, fp32 and bf16, with one
       launch per call and two calls equal bit for bit, and time them
       beside their byte bound and PyTorch's `upsample_bilinear2d`; phases
       3 and 5 check their launch counters (24 a forward, 24 a backward)
       and the replayed call's launches by kernel name;
   3b. drive the fused predictor (bf16, full width) through a few requests
       with its launch counter checked, profile one, and compare the fp32
       fused model with the fp32 "pallas" route on the card;
   5b. drive the fused train step as phase 5 drives the other (78 / 78
       launches by kernel name in the replayed step), profile one step
       (one kernel of each kind per call; the record keeps the kernels'
       device ms of that step), and compare one fp32 `_losses` and its
       pool gradient, card vs CPU, as phase 6 does;
   7.  run the grounding quality gate (`lpi_tpu_torch.bench`) with the
       gate's own config and with `deform_impl="fused"`, each held to the
       gate's bars; its sessions run the captured step. The fused one runs
       in a child process beside the other, as does phase 10's.

The pre-padded window sums (`window_accumulate_taps`, `window_accumulate`)
and their path:

   8.  hold both, forward and backward, against their plain versions at the
       microbenchmark's P3 shape and at odd ones (one launch per call, two
       backward calls equal bit for bit); run the deform-window
       microbenchmark `lpi_tpu_torch.profile_deform` (which times them, and
       the deformable conv per level by both routes) with the launch
       counters checked; time the plain versions and, for the single map,
       one `grid_sample` call beside them.

Continual retrieval (SliNet: CLIP ViT-B/16 with LPI prompts), a path that
runs none of the ten kernels (its attention, products and LayerNorms are
plain torch ops, as they are XLA code in the JAX package):

   9.  drive the full-width retrieval train step
       (`lpi_tpu_torch.continual.learner.RetrievalLearner`,
       `RetrievalConfig()`: 224 px, batch 64, bf16, task 1) for 1 + 10
       steps eagerly and 1 + 10 captured from the same starting state on
       `bench_retrieval`'s inputs, under deterministic algorithms: losses
       finite, captured against eager in bits, the current pool slices
       moved, the other slices and every tower parameter bit-identical, no
       kernel launched; per mode the median step, samples/s, peak memory,
       one step profiled; then `cluster_task` and one `evaluate` at full
       width on a small 2-task set;
   9b. one fp32 `_losses` and its pool gradient at full width and 2 layers
       a tower, card vs CPU, TF32 off, relative Frobenius 1e-4, the
       concatenated gradient and each leaf's;
   10. the retrieval quality gate (`bench_quality_retrieval`) under
       deterministic algorithms, held to its bars, printed beside the JAX
       package's values on a TPU; its sessions run the captured step. It
       runs in phase 7's slot, in a child process beside the grounding
       gates (the three are host-bound and time nothing but themselves).

The grounding bench line:

   11. `lpi_tpu_torch.bench.bench_grounding` (the full-width grounding step
       captured, timed with the seeded offsets and then with
       `honest_offsets` through the same capture): both keys,
       `grounding_train_samples_per_sec_per_chip` and
       `grounding_train_samples_per_sec_zero_offsets`, finite and > 0.

The command line (`python -m lpi_tpu_torch.cli.main`), run in this process
under deterministic algorithms, in a temporary directory deleted after it:

   12. 12a: rows 1f, 2f, 1b and 2b at P3 of the 448 px head at the command
       line's batch 16 (bf16 maps), against its plain version with the
       bars of phases 2 and 2b, one launch a call, two calls equal bit for
       bit, timed beside its bound (`check_window_shapes`, as 16b); 12b: `train-grounding --synthetic --tasks 2 --epochs 1`
       at `GroundingConfig()` (full GLIP-T + LPI, 448 px, bf16, batch 16,
       "pallas"): finite losses, the four window kernels launched (the
       counters), `base/`, both sessions, their results and `latest`
       written; 12c: `eval-all --grounding` in a fresh learner seeded 99
       (not the writer's seed) equal to the training run's head outputs on
       every eval batch in bits, and to its P@1/5/10 and task-ID accuracy;
       12d: `predict` from the checkpoint, in a learner seeded 99, equal in
       bits to a predictor on the learner that wrote it; 12e: a fresh learner captures a task-0 step, `restore`s
       session 0 and trains task 1 through the same capture: its pools and
       keys equal the uninterrupted run's in bits; 12f: the same for
       `train --synthetic --sessions 2 --epochs 1` at `RetrievalConfig()`
       with `eval --session 1` and `eval-all` (learners seeded 99) and
       `report`; 12g: the
       grounding checkpoint loaded on the CPU equal in bits to the card's
       tensors, with its bytes and its save and load seconds.

The baseline prompt types (`configs/baselines/`), at full width with seeded
weights, under deterministic algorithms:

   13. 13a: the retrieval step of phase 9 at `RetrievalConfig()` with the
       lpi section of `sprompts.json`, of `l2p.json` and with
       `prompt_type="clip"`: 1 + 2 steps eager and 1 + 2 captured from
       the same start, losses finite with the type's keys (the auxiliary
       losses are "lpi"'s alone), captured equal to eager in bits, only
       row 1 of every pool leaf moved (L2P's shared pool included), no
       deform kernel launched, median, samples/s and peak memory; then
       `cluster_task` and `evaluate` on the 2-task set (S-Prompts, CLIP),
       or the named error where the reference has no L2P evaluation; 13b:
       phase 9b's fp32 loss and pool gradient, card vs CPU, for S-Prompts
       and L2P, with L2P's chosen entries equal; 13c: phase 5's step
       ("pallas", batch 4, `honest_offsets`, 1 + 2 steps a mode) with the
       grounding section of `sprompts.json` and with `maple.json` (54 / 24 /
       54 / 24 launches by
       the counters and by kernel name, captured equal to eager in bits,
       the frozen parameters and other rows unchanged), then one request
       of each trained model eager and captured, equal; 13d: phase 6's
       fp32 loss and pool gradient at batch 1, card vs CPU, each leaf too,
       for both pools (MaPLe's replace mode and the encoder without
       interaction on the card), the head cut to 2 towers on both sides
       (`cpu_depth_cut`: the CPU's time); 13e: `train-grounding --config configs/baselines/maple.json
       --synthetic --tasks 2 --epochs 1` at `GroundingConfig()`, then
       `eval-all --grounding` in a learner seeded 99, equal to the
       training run's head outputs and results in bits.

The head's variants and GLIP-KNOW's detection mode, at `GroundingConfig()`'s
full width with seeded weights:

   14. 14a: the early-fusion request (`dyhead.early_fuse`: a VLFuse at
       embed 2048 over 8 heads between the 4,181 visual tokens and the text,
       and a BERT layer, before each of the 6 towers), 1 + 3 requests eager
       and 1 + 3 captured, equal, 54 / 24 window launches a forward by
       counter and kernel name, then fp32 card vs CPU on the head outputs
       with its first 2 towers (`cpu_depth_cut`); 14b: its train step (b4, task 1, `honest_offsets`, the fusion and
       BERT layers frozen), 1 + 3 steps a mode as phase 5 (54 / 24 / 54 / 24,
       captured equal to eager in bits), and phase 6's fp32 loss and pool
       gradient at batch 1, card vs CPU, each leaf too, with 2 towers
       (`cpu_depth_cut`); 14c:
       `predict_classes` (GLIP-KNOW) on the LPI model with five class names
       and a knowledge json written to a temporary directory, eager and
       captured, equal, 54 / 24 a forward; 14d: the plain head (no
       deformable conv, fusion or DyReLU) and the "exact" route, one request
       each, no deform kernel launched, fp32 card vs CPU (2 towers, `cpu_depth_cut`); 14e:
       `check_deform_clipping` under its 1% warning at the seeded offsets
       (at 448 px a few offsets of the seeded convs pass +-3) and
       over it with the offset convs scaled, read at `honest_offsets`
       between, each the largest of the convs' recorded shares.

The distributed steps (`lpi_tpu_torch.core.{dist,mesh}`), in child
processes started by `lpi_tpu_torch.dryrun.run_world`, so that no process
group touches the other phases:

   15. 15a: one NCCL rank on the card, a (1, 1) (data, model) mesh, the
       retrieval step at `RetrievalConfig()` (b64, task 1) 1 + 2 steps a
       mode: a learner without a mesh and one on the mesh (its collectives
       inside the graph), each eager and captured, all four equal in bits,
       no deform kernel launched; 15b: the same for the grounding step at
       `GroundingConfig()` (b4, "pallas", `honest_offsets`, 1 + 2 steps),
       54 / 24 / 54 / 24 window launches a step by counter and by kernel
       name in a profiled call; each mode's median, busy share and peak
       memory side by side; 15c: with two cards, both steps on 2 NCCL
       ranks (global b64 and b4) against the one-process runs of 15a and
       15b at relative Frobenius 1e-4 on each loss and pool leaf; with one
       card, a line that says it did not run and why.

The data and detection-evaluation surface (`lpi_tpu_torch.data.{catalog,
transforms,samplers,grounding}`, `lpi_tpu_torch.eval.{tta,coco_ap,lvis,voc,
flickr}`), under deterministic algorithms, in a temporary directory deleted
after it:

   16. 16a: a fabricated mdetr RefExp set (32 JPEGs of task 0, about
       640x480) where the catalog looks for `refexp_train` under
       `$DATASET`; `train-grounding --dataset refexp_train --tasks 1
       --epochs 1` at `GroundingConfig()` (b16, "pallas") equal in bits to
       the same command with `--ann/--image-root` on the same files (the
       results, the pools, metrics.jsonl's losses), the four window kernels
       launched in each; 16b: multi-scale training at full width (b4, bf16,
       task 1, `honest_offsets`) on that set loaded with
       `AugmentConfig(multi_scale=(480, 560, 640, 720, 800))`: a pad-to-max
       batch at 800 px through phase 5's step (1 + 2 steps eager and 1 + 2
       captured, equal in bits, 54 / 24 / 54 / 24 by counter and by kernel
       name, median, samples/s, busy share, peak memory); the first
       scale-grouped batches at 560 and 800 px (`batches_grouped`), each
       captured in its own graph and replayed, equal in bits to eager; then
       rows 1f, 2f, 1b and 2b at every level shape of 800 px (100, 50, 25,
       13, 7) and 560 px (70, 35, 18, 9, 5), b4, bf16, Cout 256, against
       their plain versions with the bars of phases 2 and 2b, one launch a
       call, two calls equal bit for bit, timed beside their bounds; 16c:
       `eval.tta.multi_scale_detect` over `GroundingPredictor` requests at
       448, 560 and 800 px with flips (six forwards), eager and captured,
       equal merged detections, the forwards' launches by the counters,
       then the fp32 head outputs at 560 px, card vs CPU, at phase 4's bar
       (2 towers, `cpu_depth_cut`);
       16d: `eval-detection` with the COCO, LVIS, VOC and Flickr protocols
       on 16c's detections written as a predictions json against a
       fabricated ground truth, every value finite and equal to the
       evaluator called directly.

The detector zoo (`lpi_tpu_torch/models/glip/{resnet,swin,swin_variants,
efficientnet,fbnet,fcos,retina,atss_head,roi_heads,roi_mask_keypoint}.py`,
`ops/{roi_align,deform_pool,nms}.py`, `native.py`), published widths, 80
classes, seeded weights; plain PyTorch, no kernel of the repo:

   17. 17a: ResNet-50, Swin-T (v1, v2 and VL with a 256-token, 768-wide
       padded text), FBNet-C at 800x1216 and EfficientNet-B0 + BiFPN (64
       channels, 3 layers) at 512x512, b2, bf16 and fp32: each level's
       shape, finite, the forward's median of 20 CUDA-graph replays, peak
       memory, the fp32 forward twice equal in bits; 17b: the FCOS (256, 4
       convs), RetinaNet (256, 4 convs, 9 anchors) and ATSS (128, 2 convs)
       heads over P3-P7 of 800x1216, b2, 20 GT slots an image: forward,
       losses, a backward into the head, finite, the fp32 forward twice
       equal in bits, the eager step's median; 17c: `multilevel_roi_align`
       of 512 ROIs an image over P2-P5 into `BoxHead` and `roi_box_loss`,
       `MaskHead` on 128 ROIs (14 -> 28), `KeypointHead` (17 keypoints,
       56 px) on 64 ROIs, `deform_psroi_pool` of 300 ROIs with offsets on
       the stride-16 map (group 7, out 7, 8 x 49 channels): forward, loss,
       backward, finite, bits, median; 17d: every module of 17a-17c card vs
       CPU at full channel widths on small images (backbone outputs and the
       steps' losses in fp32, TF32 off; the steps' losses and gradients
       also in fp64, where cuDNN's fp32 backward algorithms cannot blur
       them), the repo's bar, the largest error printed; 17e: the native
       library built here with g++, `nms_cpu`, `ml_nms_cpu` and
       `soft_nms_cpu` on 2,000 boxes against `ops/nms.py` on the card and
       `roi_align_cpu` against `ops/roi_align.py` on the card. Any
       comparison over its bar fails the phase at its end.

The tooling (`lpi_tpu_torch/core/{profiling,ema,logging}.py`,
`continual/freeze.py`, `serve/predictor.py:launch_webui`, the command
`serve`) around the main path:

   18. 18a: phase 5's step (`GroundingConfig()`, b4, 448 px, bf16,
       "pallas", task 1, `honest_offsets`), 1 + 5 captured: `StepTimer`'s
       p50 beside the host-clock median; one step under `profiling.trace`,
       its Chrome trace's window kernels by name (54 / 24 / 54 / 24);
       `device_memory_stats` against the allocator; an EMA of every
       parameter updated after each step, one update timed beside its
       byte bound and held card vs CPU at relative 1e-6 (equal bits
       printed); one eager gradient of `_losses`
       through `mask_grads` (row 1 kept, the other rows zero) and
       `count_trainable` against the pools' row-1 scalars; the losses
       through `MetricLogger` and one `log_line`; 18b: `compiled_flops`
       of one eager b64 retrieval step (`RetrievalConfig()`) against
       `retrieval_step_flops`, within 5%; 18c: `serve` at full width
       with a stub `gradio` (whether a real one imports is printed), its
       `infer` on a seeded 480x640 image with "all" and "R@1" equal pixel
       for pixel to the drawings of the same predictor's `predict`, at the
       config's thresholds and at 0, the launch counters over the requests
       and one request's window kernels by name (54 / 24).

Each phase drops its learners and predictors, and with them their graphs'
memory pools, before the next.

Every launch counter is set to 0 just before the path it reads and read
just after. The last lines are the kernels' JSON record (ten kernels), the
card's name and power limit, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import statistics
import sys
import time

# cuBLAS reads this before its first use; the quality gate (phase 7) runs
# with deterministic algorithms, which need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from lpi_tpu_torch.profile_deform import (bound_ms, card_line, device_time_ms,  # noqa: E402
                                          eager_time_ms, window_bound_ms)

M, K, KW = 3, 9, 3
# (input side, launches per tower) of one 448 px forward: conv_same runs at
# the five levels, conv_up at levels 1-4 (stride 1); conv_down reads levels
# 0-3 (stride 2). Six towers. A train step runs each backward kernel once
# per forward launch.
INPAD_SHAPES = {56: 1, 28: 2, 14: 2, 7: 2, 4: 2}
S2_SHAPES = {56: 1, 28: 1, 14: 1, 7: 1}
TOWERS = 6
PREDICT_BATCH, TRAIN_BATCH = 1, 4
TRAIN_TASK = 1
REL_TOL = 1e-5  # kernel vs plain: both sum in fp32, in different orders
# the plain versions take 5-700 ms a call: their time is the median of 3
# replays after one eager warm-up (the kernels': 20 after 3)
PLAIN_REPS = 3
# the gate's config at 64 px: levels 8, 4, 2, 1, 1; two towers, batch 4
GATE_S1_SHAPES = {8: 1, 4: 2, 2: 2, 1: 4}
GATE_S2_SHAPES = {8: 1, 4: 1, 2: 1, 1: 1}
GATE_TOWERS, GATE_CHANNELS = 2, 16
# rows 3 and 4, the pre-padded sums, reached by the deform-window
# microbenchmark; held at its P3 shape and at odd ones: (batch, output
# rows, output columns, Cout, taps of row 3, m); row 4 runs each with K = 1
PADDED_KERNELS = ("window_accumulate_taps", "window_accumulate_taps_backward",
                  "window_accumulate", "window_accumulate_backward")
PADDED_CASES = ((TRAIN_BATCH, 56, 56, 256, K, M), (2, 13, 9, 12, 9, 3), (1, 7, 10, 3, 4, 2),
                (3, 5, 6, 12, 4, 1), (1, 9, 4, 256, 9, 1))
# the bilinear upsample: (h, w, H, W) of the four upsampled levels of a 448
# px tower, held at the ground-train-b16 cell's batch and width (the record
# sums them over six towers), and a request's odd level pair (a 640 x 360
# image's), batch 1
RESIZE_LEVELS = ((28, 28, 56, 56), (14, 14, 28, 28), (7, 7, 14, 14), (4, 4, 7, 7))
RESIZE_ODD = (23, 40, 45, 80)
RESIZE_BATCH, RESIZE_CHANNELS = 16, 256
# the upsample's wrappers and their device kernels' names
RESIZE_KERNELS = {"resize_bilinear_forward": "resize_bilinear_fwd_kernel",
                  "resize_bilinear_backward": "resize_bilinear_bwd_kernel"}


def log(*args):
    print(*args, flush=True)


def offset_inputs(gen, batch: int, Ho: int, Wo: int | None = None, taps: int = K, m: int = M):
    """Offsets (uniform in [-m, m], with exact integers and the +-m edges
    mixed in) and a gate (with exact 0 and 1 entries), [B, taps, Ho, Wo]
    (Wo = Ho by default)."""
    shape = (batch, taps, Ho, Ho if Wo is None else Wo)
    oy = (torch.rand(*shape, device="cuda", generator=gen) * 2 - 1) * m
    ox = (torch.rand(*shape, device="cuda", generator=gen) * 2 - 1) * m
    oy.view(-1)[::7] = torch.round(oy.view(-1)[::7])
    ox.view(-1)[::5] = torch.round(ox.view(-1)[::5])
    oy.view(-1)[::11] = float(m)
    ox.view(-1)[::13] = -float(m)
    gate = torch.rand(*shape, device="cuda", generator=gen)
    gate.view(-1)[::6] = 0.0
    gate.view(-1)[::17] = 1.0
    return oy.contiguous(), ox.contiguous(), gate.contiguous()


def kernel_inputs(gen, side: int, stride: int, dtype, batch: int, Cout: int = 256):
    """Product map, offsets and gate (`offset_inputs`) and a cotangent."""
    Ho = (side + stride - 1) // stride
    h = torch.randn(batch, side, side, K * Cout, device="cuda", generator=gen).to(dtype)
    oy, ox, gate = offset_inputs(gen, batch, Ho)
    ct = torch.randn(batch, Ho, Ho, Cout, device="cuda", generator=gen)
    return h.contiguous(), oy, ox, gate, ct


def _record(name, replaces, source="lpi_tpu_torch/csrc/deform_window.cu"):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "library_ms": None, "bound_kinds": set()}


def check_forward_kernels(dk, gen, records):
    """Phase 2: the forward kernels at the predictor's (batch 1) and the
    train step's (batch 4) shapes, one launch per call and two calls equal
    bit for bit (no atomics, a fixed order); the bound counts the rows of h
    that these offsets and gates weight (`window_bound_ms(offsets=...)`).
    The record sums the train step's launches (bf16 maps), `predict_ms` the
    predictor's."""
    specs = (("window_accumulate_taps_inpad", 1, INPAD_SHAPES, dk.window_accumulate_taps_inpad,
              dk.window_accumulate_taps_inpad_reference),
             ("window_accumulate_taps_s2", 2, S2_SHAPES, dk.window_accumulate_taps_s2,
              dk.window_accumulate_taps_s2_reference))
    for name, stride, shapes, fn, ref_fn in specs:
        rec = records[name]
        rec["predict_ms"] = 0.0
        for batch in (PREDICT_BATCH, TRAIN_BATCH):
            for dtype in (torch.float32, torch.bfloat16):
                for side, per_tower in shapes.items():
                    h, oy, ox, g, _ = kernel_inputs(gen, side, stride, dtype, batch)
                    args = (h, oy, ox, g, M, K, KW)
                    want = ref_fn(*args)
                    got = _launched_once(fn, *args)
                    if not torch.equal(got, _launched_once(fn, *args)):
                        raise AssertionError(f"{name} {dtype} b{batch} side {side}: two calls "
                                             f"differ")
                    err = (got - want).abs().max().item()
                    scale = max(1.0, want.abs().max().item())
                    if not (err <= REL_TOL * scale and torch.isfinite(got).all()):
                        raise AssertionError(f"{name} {dtype} b{batch} side {side}: max abs "
                                             f"err {err} > {REL_TOL} x {scale}")
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
                    ms = device_time_ms(lambda: fn(*args), inner=10)
                    plain = device_time_ms(lambda: ref_fn(*args), reps=PLAIN_REPS, warmup=1)
                    eager = eager_time_ms(lambda: fn(*args))
                    bms, kind = window_bound_ms(h, oy, 256, offsets=(ox, g, stride, M, KW))
                    log(f"kernel {name} {str(dtype)[6:]} b{batch} in {side}x{side}x{K * 256} "
                        f"stride {stride}: {ms:.6f} ms, plain {plain:.6f} ms, bound "
                        f"{bms:.6f} ms ({kind}, the weighted rows of h; {100 * bms / ms:.1f}% "
                        f"of it; one read of all of h {window_bound_ms(h, oy, 256)[0]:.6f} ms), "
                        f"eager call {eager:.6f} ms, max abs err {err:.3e} (tol {REL_TOL} x "
                        f"{scale:.3f}); two calls equal bit for bit")
                    if dtype != torch.bfloat16:  # the 448 px model's maps are bf16
                        continue
                    n = per_tower * TOWERS
                    if batch == PREDICT_BATCH:
                        rec["predict_ms"] += n * ms
                        continue
                    rec["ms"] += n * ms
                    rec["plain_ms"] += n * plain
                    rec["bound_ms"] += n * bms
                    rec["bound_kinds"].add(kind)


def check_backward_kernels(dk, gen, records):
    """Phase 2b: the backward kernels at the train step's shapes (batch 4),
    fp32 and bf16 maps. d oy, d ox, d gate and fp32 d h_all within 1e-5 x
    max(1, max |plain|); a bf16 d h_all is held to the plain fp32 sum over
    the same bf16 values, within that plus half a bf16 step (2^-8 |plain|),
    since the kernel rounds its fp32 sum to bf16 once. One launch per call,
    and a second call gives the same bits (no atomics, a fixed order)."""
    specs = (("window_accumulate_taps_inpad_backward", 1, INPAD_SHAPES,
              dk.window_accumulate_taps_inpad_backward,
              dk.window_accumulate_taps_inpad_backward_reference),
             ("window_accumulate_taps_s2_backward", 2, S2_SHAPES,
              dk.window_accumulate_taps_s2_backward,
              dk.window_accumulate_taps_s2_backward_reference))
    for name, stride, shapes, fn, ref_fn in specs:
        rec = records[name]
        for dtype in (torch.float32, torch.bfloat16):
            for side, per_tower in shapes.items():
                h, oy, ox, g, ct = kernel_inputs(gen, side, stride, dtype, TRAIN_BATCH)
                args = (h, oy, ox, g, ct, M, K, KW)
                got = _launched_once(fn, *args)
                if not all(torch.equal(a, b) for a, b in zip(got, _launched_once(fn, *args))):
                    raise AssertionError(f"{name} {dtype} side {side}: two calls differ")
                want = ref_fn(h.float(), oy, ox, g, ct, M, K, KW)
                torch.cuda.synchronize()
                if got[0].dtype != dtype:
                    raise AssertionError(f"{name}: d h_all is {got[0].dtype}, want {dtype}")
                errs = []
                for what, a, b in zip(("dh", "doy", "dox", "dgate"), got, want):
                    err = _held(f"{name} {dtype} side {side} {what}", a, b,
                                bf16=what == "dh" and dtype == torch.bfloat16)
                    errs.append(f"{what} {err:.3e}")
                    if what != "dh" or dtype == torch.float32:
                        rec["max_abs_err"] = max(rec["max_abs_err"], err)
                ms = device_time_ms(lambda: fn(*args), inner=10)
                plain = device_time_ms(lambda: ref_fn(*args), reps=PLAIN_REPS, warmup=1)
                bms, kind = window_bound_ms(h, oy, 256, backward=True)
                log(f"kernel {name} {str(dtype)[6:]} b{TRAIN_BATCH} in {side}x{side}x{K * 256} "
                    f"stride {stride}: {ms:.6f} ms, plain {plain:.6f} ms, bound {bms:.6f} ms "
                    f"({kind}; {100 * bms / ms:.1f}% of it), max abs err {', '.join(errs)}; "
                    f"two calls equal bit for bit")
                if dtype == torch.bfloat16:
                    n = per_tower * TOWERS
                    rec["ms"] += n * ms
                    rec["plain_ms"] += n * plain
                    rec["bound_ms"] += n * bms
                    rec["bound_kinds"].add(kind)


def fused_inputs(gen, side: int, stride: int, batch: int, C: int):
    """Features, offsets and gate (`offset_inputs`), weights and a
    cotangent, fp32, Cout = C."""
    Ho = (side + stride - 1) // stride
    f = torch.randn(batch, side, side, C, device="cuda", generator=gen)
    oy, ox, gate = offset_inputs(gen, batch, Ho)
    w = torch.randn(K, C, C, device="cuda", generator=gen) / np.sqrt(K * C)
    ct = torch.randn(batch, Ho, Ho, C, device="cuda", generator=gen)
    return f, oy, ox, gate, w, ct


def fused_bound_ms(f, oy, C, Cout, backward=False, dw=False):
    """Least time of the fused conv: bytes (features, offsets, gate and W
    read once, the output written once; for the VJP also the cotangent read
    and d feats, d offsets, d gate (and d W) written) over the HBM rate vs
    the fp32 operations (2 K C Cout per output pixel for each product, 8 K C
    for each bilinear pass: 4 corners, a multiply and an add) over the fp32
    rate."""
    B, _, Ho, Wo = oy.shape
    P = B * Ho * Wo
    w_bytes = K * C * Cout * 4
    nbytes = f.numel() * 4 + 3 * oy.numel() * 4 + w_bytes + P * Cout * 4
    flops = P * (2 * K * C * Cout + 8 * K * C)
    if backward:  # U = ct W^T, then the d f gather and the offset sums
        nbytes += f.numel() * 4 + 3 * oy.numel() * 4
        flops = P * (2 * K * C * Cout + 16 * K * C)
        if dw:  # re-sample and samp^T ct
            nbytes += w_bytes
            flops += P * (2 * K * C * Cout + 8 * K * C)
    return bound_ms(nbytes, flops)


def _held(name, got, want, bf16=False):
    """Max abs error of `got` against the plain fp32 `want`, held to 1e-5 x
    max(1, max |plain|); a result that the kernel rounds to bf16 once
    (`bf16`) gets half a bf16 step (2^-8 |plain|) more."""
    got = got.float()
    err = (got - want).abs().max().item()
    excess = (got - want).abs() - REL_TOL * max(1.0, want.abs().max().item())
    if bf16:
        excess = excess - 2.0 ** -8 * want.abs()
    if not (excess.max().item() <= 0 and torch.isfinite(got).all()):
        raise AssertionError(f"{name}: max abs err {err} over the bar {REL_TOL} x max(1, "
                             f"max |plain|){' + 2^-8 |plain|' if bf16 else ''}")
    return err


def check_fused_kernels(fk, gen, records):
    """Phase 2c: the fused forward and backward kernels against their plain
    versions, fp32, at the 448 px predictor's (batch 1) and train step's
    (batch 4) shapes, 256 channels, and at the gate's (batch 4, 16
    channels, 64 px); one launch counted per call, two calls of each (the
    backward with d W) equal bit for bit, and each level's share of the
    bound. The records sum the 448 px train step's launches (the backward
    without d W: the continual step's head is frozen); `predict_ms` the
    predictor's forward; `dw_ms` the backward with d W."""
    fwd, bwd = records["fused_deform"], records["fused_deform_backward"]
    fwd["predict_ms"] = 0.0
    bwd["dw_ms"] = 0.0
    configs = (("448px", 256, TOWERS, (PREDICT_BATCH, TRAIN_BATCH), INPAD_SHAPES, S2_SHAPES),
               ("gate", GATE_CHANNELS, GATE_TOWERS, (TRAIN_BATCH,), GATE_S1_SHAPES,
                GATE_S2_SHAPES))
    for label, C, towers, batches, s1, s2 in configs:
        for batch in batches:
            for stride, shapes in ((1, s1), (2, s2)):
                for side, per_tower in shapes.items():
                    f, oy, ox, g, w, ct = fused_inputs(gen, side, stride, batch, C)
                    args = (f, oy, ox, g, w, M, KW, stride)
                    where = f"{label} b{batch} {side} s{stride}"
                    got = _launched_once(fk.fused_deform, *args)
                    if not torch.equal(got, _launched_once(fk.fused_deform, *args)):
                        raise AssertionError(f"fused_deform {where}: two calls differ")
                    err = _held(f"fused_deform {where}", got, fk.fused_deform_reference(*args))
                    fwd["max_abs_err"] = max(fwd["max_abs_err"], err)
                    want = fk.fused_deform_backward_reference(f, oy, ox, g, w, ct, M, KW,
                                                              stride)
                    errs = []
                    for need_dw in (False, True):
                        got = _launched_once(fk.fused_deform_backward, f, oy, ox, g, w, ct, M,
                                             KW, stride, need_dw)
                        if (got[4] is None) == need_dw:
                            raise AssertionError("fused_deform_backward: d W presence")
                        if need_dw and not all(torch.equal(a, b) for a, b in zip(
                                got, fk.fused_deform_backward(f, oy, ox, g, w, ct, M, KW,
                                                              stride))):
                            raise AssertionError(f"fused_deform_backward {where}: two calls "
                                                 f"differ")
                        for what, a, b in zip(("df", "doy", "dox", "dgate", "dw"), got, want):
                            if a is not None:
                                errs.append(_held(f"fused_deform_backward {label} b{batch} "
                                                  f"{side} s{stride} {what}", a, b))
                    bwd["max_abs_err"] = max(bwd["max_abs_err"], *errs)
                    bargs = (f, oy, ox, g, w, ct, M, KW, stride)
                    ms = device_time_ms(lambda: fk.fused_deform(*args))
                    plain = device_time_ms(lambda: fk.fused_deform_reference(*args),
                                           reps=PLAIN_REPS, warmup=1)
                    bms = device_time_ms(lambda: fk.fused_deform_backward(*bargs, need_dw=False))
                    bdw = device_time_ms(lambda: fk.fused_deform_backward(*bargs))
                    bplain = device_time_ms(
                        lambda: fk.fused_deform_backward_reference(*bargs, need_dw=False),
                        reps=PLAIN_REPS, warmup=1)
                    fb, fkind = fused_bound_ms(f, oy, C, C)
                    bb, bkind = fused_bound_ms(f, oy, C, C, backward=True)
                    bbdw, _ = fused_bound_ms(f, oy, C, C, backward=True, dw=True)
                    log(f"kernel fused_deform {label} b{batch} in {side}x{side}x{C} stride "
                        f"{stride}: {ms:.6f} ms, plain {plain:.6f} ms, bound {fb:.6f} ms "
                        f"({fkind}; {100 * fb / ms:.1f}% of it), max abs err {err:.3e}; "
                        f"backward {bms:.6f} ms (with d W {bdw:.6f} ms), plain {bplain:.6f} ms, "
                        f"bound {bb:.6f} ms ({bkind}; {100 * bb / bms:.1f}% of it; with d W "
                        f"{bbdw:.6f} ms, {100 * bbdw / bdw:.1f}%), max abs err {max(errs):.3e}; "
                        f"two calls of each equal bit for bit")
                    if label != "448px":
                        continue
                    n = per_tower * towers
                    if batch == PREDICT_BATCH:
                        fwd["predict_ms"] += n * ms
                        continue
                    for rec, t, p, b, kind in ((fwd, ms, plain, fb, fkind),
                                               (bwd, bms, bplain, bb, bkind)):
                        rec["ms"] += n * t
                        rec["plain_ms"] += n * p
                        rec["bound_ms"] += n * b
                        rec["bound_kinds"].add(kind)
                    bwd["dw_ms"] += n * bdw


def check_resize_kernels(gen, records):
    """Phase 2d: the bilinear upsample's kernels at the b16 train step's four
    levels and a request's odd size (batch 1), fp32 and bf16 maps: one
    launch per call and two calls equal bit for bit; the forward held to
    `resize_bilinear_reference` (`F.interpolate`), the backward to
    `resize_bilinear_backward_reference` (the gather form) and to autograd
    through `F.interpolate`, each within 1e-5 x max(1, max |plain|), a bf16
    result with half a bf16 step more (`_held`; the plain versions take the
    same values in fp32). Timed beside the byte bound (every element of the
    input and the output once), the plain versions (eager, host included:
    the gather form's index tables are made on the host) and PyTorch's
    `upsample_bilinear2d` forward and backward on the channels-last view.
    The records sum the b16 step's bf16 launches, four levels in each of six
    towers."""
    from lpi_tpu_torch.ops import resize_bilinear as rb

    fwd, bwd = records["resize_bilinear_forward"], records["resize_bilinear_backward"]
    fwd["library_ms"] = bwd["library_ms"] = 0.0
    cases = [(RESIZE_BATCH, *lv) for lv in RESIZE_LEVELS] + [(1, *RESIZE_ODD)]
    for B, h, w, H, W in cases:
        C = RESIZE_CHANNELS
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(B, h, w, C, device="cuda", generator=gen).to(dtype)
            ct = torch.randn(B, H, W, C, device="cuda", generator=gen).to(dtype)
            y = _launched_once(rb.resize_bilinear_forward, x, H, W)
            dx = _launched_once(rb.resize_bilinear_backward, ct, h, w)
            if not (torch.equal(y, _launched_once(rb.resize_bilinear_forward, x, H, W))
                    and torch.equal(dx, _launched_once(rb.resize_bilinear_backward, ct, h, w))):
                raise AssertionError(f"resize_bilinear {dtype} b{B} {h}x{w}->{H}x{W}: two "
                                     f"calls differ")
            bf16 = dtype == torch.bfloat16
            label = f"{str(dtype)[6:]} b{B} {h}x{w}->{H}x{W}x{C}"
            x32 = x.float().requires_grad_(True)
            y32 = rb.resize_bilinear_reference(x32, H, W)
            (auto,) = torch.autograd.grad(y32, x32, ct.float())
            errs = (_held(f"resize_bilinear_forward {label}", y, y32.detach(), bf16),
                    _held(f"resize_bilinear_backward {label}", dx,
                          rb.resize_bilinear_backward_reference(ct.float(), h, w), bf16),
                    _held(f"resize_bilinear_backward {label} (autograd)", dx, auto, bf16))
            if not bf16:
                fwd["max_abs_err"] = max(fwd["max_abs_err"], errs[0])
                bwd["max_abs_err"] = max(bwd["max_abs_err"], *errs[1:])
            xn, ctn = x.permute(0, 3, 1, 2), ct.permute(0, 3, 1, 2)  # channels-last NCHW views
            nbytes = (x.numel() + ct.numel()) * x.element_size()
            for rec, fn, plain, library, flops in (
                    (fwd, lambda: rb.resize_bilinear_forward(x, H, W),
                     lambda: rb.resize_bilinear_reference(x, H, W),
                     lambda: torch.ops.aten.upsample_bilinear2d(xn, [H, W], False),
                     6 * ct.numel()),
                    (bwd, lambda: rb.resize_bilinear_backward(ct, h, w),
                     lambda: rb.resize_bilinear_backward_reference(ct, h, w),
                     lambda: torch.ops.aten.upsample_bilinear2d_backward(
                         ctn, [H, W], [B, C, h, w], False),
                     8 * ct.numel())):
                ms = device_time_ms(fn, inner=10)
                plain_ms = eager_time_ms(plain, reps=PLAIN_REPS, inner=1)
                lib_ms = device_time_ms(library, inner=10)
                bms, kind = bound_ms(nbytes, flops)
                log(f"kernel {rec['name']} {label}: {ms:.6f} ms, bound {bms:.6f} ms ({kind}; "
                    f"{100 * bms / ms:.1f}% of it), plain {plain_ms:.6f} ms (eager), "
                    f"upsample_bilinear2d {lib_ms:.6f} ms; max abs err "
                    f"{', '.join(f'{e:.3e}' for e in errs)}; two calls equal bit for bit")
                if bf16 and B == RESIZE_BATCH:
                    rec["ms"] += TOWERS * ms
                    rec["plain_ms"] += TOWERS * plain_ms
                    rec["bound_ms"] += TOWERS * bms
                    rec["library_ms"] += TOWERS * lib_ms
                    rec["bound_kinds"].add(kind)
    log(f"resize_bilinear per b16 step (bf16, {TOWERS} towers x {len(RESIZE_LEVELS)} levels): "
        f"forward {fwd['ms']:.6f} ms (bound {fwd['bound_ms']:.6f}), backward {bwd['ms']:.6f} "
        f"ms (bound {bwd['bound_ms']:.6f})")


def _profile(run, what):
    """`run()` under torch.profiler: wall time, the device's busy time (the
    sum of its kernels' times), the host ranges and the kernels that take
    the most device time. -> (the device kernels' events, {"wall", "busy"
    (ms), "kernels" (count)})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile: one {what} {wall:.3f} ms wall (profiled), device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}%), {sum(e.count for e in kernels)} "
        f"device kernels; {time.perf_counter() - start:.3f} s with the profiler's own work")
    for e in events:
        if e.is_user_annotation and e.device_type == DeviceType.CPU:
            log(f"profile range {e.key}: {e.cpu_time_total / 1e3:.3f} ms host")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        log(f"profile kernel {e.self_device_time_total / 1e3:.3f} ms x{e.count}: "
            f"{e.key[:100]}")
    return kernels, {"wall": wall, "busy": busy, "kernels": sum(e.count for e in kernels)}


# the window kernels' wrappers by (stride, backward), as their device
# kernels' names give them
WINDOW_KERNELS = {(1, False): "window_accumulate_taps_inpad",
                  (2, False): "window_accumulate_taps_s2",
                  (1, True): "window_accumulate_taps_inpad_backward",
                  (2, True): "window_accumulate_taps_s2_backward"}
WINDOW_KERNEL_NAME = re.compile(r"window_taps(_bwd)?_kernel<[^,]+, (\d)")


def replay_launches(kernels, route) -> dict:
    """The deform kernels' launches among one profiled call's device kernels,
    by wrapper, read from the kernels' names (the wrappers' own counters
    count host calls, which a graph replay makes none of): the window
    kernels by stride and direction; the fused forward, and the fused
    backward as its sample launch (one U product beside each is checked
    by `record_fused_split`)."""
    if route == "fused":
        times = fused_kernel_times(kernels)
        out = {"fused_deform": times.get("fused_fwd_kernel", (0, 0.0))[0],
               "fused_deform_backward": times.get("fused_bwd_sample_kernel", (0, 0.0))[0]}
        return {k: n for k, n in out.items() if n}
    return {WINDOW_KERNELS[key]: n for key, (n, _) in deform_kernel_times(kernels).items()}


def check_replay_launches(dk, fk, cfg, kernels, train: bool, what: str) -> dict:
    """One profiled call's deform launches by kernel name against one
    forward's (and, when `train`, one backward's) expected launches."""
    got = replay_launches(kernels, cfg.dyhead.deform_impl)
    want = {k: n for k, n in expected_counts(dk, fk, cfg, 1, train).items() if n}
    log(f"{what}: deform kernel launches by name in the profiled call {got}")
    if got != want:
        raise AssertionError(f"{what}: launches by kernel name {got}, want {want}")
    return got


def same_bits(runs, what: str) -> None:
    """Eager against captured: every step's metrics and every pool leaf
    after the last step equal in bits; if not, within the repo's bar
    (relative Frobenius 1e-4 on each), with the largest error printed."""
    eager, captured = runs["eager"], runs["captured"]
    pairs = [(f"step {i} {k}", np.float64(a[k]), np.float64(b[k]))
             for i, (a, b) in enumerate(zip(eager["losses"], captured["losses"])) for k in a]
    pairs += [(name, eager["pools"][name].double().cpu().numpy(),
               captured["pools"][name].double().cpu().numpy()) for name in eager["pools"]]
    unequal = [(name, a, b) for name, a, b in pairs if not np.array_equal(a, b)]
    if not unequal:
        log(f"{what}: captured equals eager in bits: {len(eager['losses'])} steps' metrics and "
            f"{len(eager['pools'])} pool leaves")
        return
    worst = max((np.linalg.norm(np.ravel(a - b)) / max(np.linalg.norm(np.ravel(a)), 1e-30), name)
                for name, a, b in unequal)
    log(f"{what}: captured differs from eager in bits at {len(unequal)} of {len(pairs)} values: "
        f"{[name for name, _, _ in unequal]}; largest relative Frobenius {worst[0]:.3e} at "
        f"{worst[1]} (bar 1e-4)")
    if worst[0] > 1e-4:
        raise AssertionError(f"{what}: captured and eager disagree beyond the bar")


def busy_share(stats) -> str:
    """A profiled call's device busy share, or "not profiled"."""
    if stats is None:
        return "not profiled"
    return (f"device busy {stats['busy']:.3f} of {stats['wall']:.3f} ms "
            f"({100 * stats['busy'] / stats['wall']:.1f}%) in a profiled call, "
            f"{stats['kernels']} device kernels a call")


def mode_summary(runs, what: str, batch: int) -> None:
    for mode, r in runs.items():
        log(f"{what} {mode} on {card_line()}: median {r['med']:.3f} ms, "
            f"{1e3 * batch / r['med']:.3f} samples/s, {busy_share(r['stats'])}, peak memory "
            f"{r['peak'] / 2**30:.3f} GiB")


def deform_kernel_times(kernels):
    """Device ms of the four deform window kernels among profiled events,
    by (stride, backward)."""
    out = {}
    for e in kernels:
        m = WINDOW_KERNEL_NAME.search(e.key)
        if m:
            key = (int(m.group(2)), bool(m.group(1)))
            n, ms = out.get(key, (0, 0.0))
            out[key] = (n + e.count, ms + e.self_device_time_total / 1e3)
    return out


def fused_kernel_times(kernels):
    """Device ms and launches of the fused deform kernels among profiled
    events, by kernel name."""
    out = {}
    for e in kernels:
        m = re.search(r"(fused_fwd_kernel|u_product_kernel|fused_bwd_sample_kernel|"
                      r"dw_partial_kernel|dw_sum_kernel)", e.key)
        if m:
            n, ms = out.get(m.group(1), (0, 0.0))
            out[m.group(1)] = (n + e.count, ms + e.self_device_time_total / 1e3)
    return out


def assert_close(ours, theirs, what, rel=1e-4, atol=3e-3, where="card vs cpu", dtype="fp32"):
    """The repo's composed-output bar: relative Frobenius error <= rel plus
    an absolute per-element cap."""
    ours = np.asarray(ours, np.float64)
    theirs = np.asarray(theirs, np.float64)
    frob = np.linalg.norm(ours - theirs) / max(np.linalg.norm(theirs), 1e-6)
    worst = np.abs(ours - theirs).max()
    log(f"{dtype} {where} {what}: rel frobenius {frob:.3e} (bar {rel}), max abs "
        f"{worst:.3e} (cap {atol})")
    if not (frob <= rel and worst <= atol):
        raise AssertionError(f"{what}: card and cpu disagree")


def launch_counts(dk, fk) -> dict:
    """Every kernel wrapper's launch counter, and the fused backward's calls
    that computed d W."""
    out = {fn.__name__: fn.launches for fn in (*dk.KERNELS, *fk.KERNELS)}
    out["fused_deform_backward.dw"] = fk.fused_deform_backward.dw_launches
    return out


def reset_counts(dk, fk) -> None:
    from lpi_tpu_torch.ops import resize_bilinear as rb

    dk.reset_launch_counts()
    fk.reset_launch_counts()
    rb.reset_launch_counts()


def resize_per_call(cfg, train: bool) -> dict:
    """The upsample's launches in one call of the head (and, when `train`,
    its backward): one in each tower at every level but the last (24 at 448
    px: six towers, five levels)."""
    per = cfg.dyhead.num_convs * (len(cfg.atss.anchor_strides) - 1)
    return {"resize_bilinear_forward": per, "resize_bilinear_backward": per if train else 0}


def check_resize_launches(cfg, calls: int, train: bool, what: str) -> dict:
    """The upsample's launch counters over `calls` host calls of the head
    against `resize_per_call`. -> the counters."""
    from lpi_tpu_torch.ops import resize_bilinear as rb

    got = {name: getattr(rb, name).launches for name in RESIZE_KERNELS}
    want = {name: n * calls for name, n in resize_per_call(cfg, train).items()}
    log(f"{what}: upsample launch counters {got} over {calls} host calls")
    if got != want:
        raise AssertionError(f"{what}: upsample launches {got}, want {want}")
    return got


def check_resize_replay(cfg, kernels, train: bool, what: str) -> dict:
    """One profiled call's upsample launches by kernel name against
    `resize_per_call` (a replay makes no host call, so the counters cannot
    see it). -> the launches by wrapper."""
    got = {name: sum(e.count for e in kernels if kernel in e.key)
           for name, kernel in RESIZE_KERNELS.items()}
    log(f"{what}: upsample launches by kernel name in the profiled call {got}")
    if got != resize_per_call(cfg, train):
        raise AssertionError(f"{what}: upsample launches by kernel name {got}, want "
                             f"{resize_per_call(cfg, train)}")
    return got


def expected_counts(dk, fk, cfg, n: int, train: bool) -> dict:
    """Launches of `n` forwards (and, when `train`, their backwards) of the
    head: per tower conv_same at every level and conv_up at all but the last
    run at stride 1, conv_down at all but the first at stride 2 (54 and 24
    at 448 px, six towers); the fused route takes both strides through one
    entry (78) and never computes d W (the head is frozen)."""
    levels, towers = len(cfg.atss.anchor_strides), cfg.dyhead.num_convs
    s1, s2 = towers * (2 * levels - 1) * n, towers * (levels - 1) * n
    want = dict.fromkeys(launch_counts(dk, fk), 0)
    if cfg.dyhead.deform_impl == "fused":
        want["fused_deform"] = s1 + s2
        want["fused_deform_backward"] = (s1 + s2) if train else 0
    else:
        want["window_accumulate_taps_inpad"] = s1
        want["window_accumulate_taps_s2"] = s2
        if train:
            want["window_accumulate_taps_inpad_backward"] = s1
            want["window_accumulate_taps_s2_backward"] = s2
    return want


def train_phase(dk, fk, cfg, tok, records, what=None, keep_model=False, n_steps=5,
                batch=None, profile_eager=True):
    """Phases 5 and 5b: the full-width train step, batch 4, 448 px, bf16,
    task 1, on the route `cfg.dyhead.deform_impl` names, with the offset
    convs at a trained model's size (`honest_offsets`): 1 + `n_steps` steps
    eagerly, then 1 + `n_steps` captured (the first step warms up and
    captures) from the
    same starting state, under deterministic algorithms. Per mode: the
    launch counters, the median step, samples/s, a profiled step's busy
    share and kernels, the peak memory; the replayed step's deform launches
    by kernel name; captured against eager in bits; the frozen parameters
    and the other tasks' rows bit-identical. `what` names the run in the
    log (the route by default); `batch` replaces the synthetic 448 px batch
    (phase 16b's multi-scale batch). `profile_eager=False` profiles the
    captured step alone (the profiler's own work over an eager step takes
    17-22 s). -> the batch, and with `keep_model` the trained model too."""
    from lpi_tpu_torch.bench import deterministic, honest_offsets
    from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
    from lpi_tpu_torch.data.grounding import synthetic_grounding_task
    from lpi_tpu_torch.graphs import WARMUP

    route = cfg.dyhead.deform_impl
    label = what or route
    t = time.perf_counter()
    learner = GroundingLearner(cfg, generator=torch.Generator().manual_seed(0), device="cuda")
    honest_offsets(learner.model)
    log(f"train {label}: learner built in {time.perf_counter() - t:.3f} s; offset convs "
        f"scaled (kernel x30, bias[:18] ~ N(0, 1)) for realistic offsets")
    if batch is None:
        ds = synthetic_grounding_task(TRAIN_TASK, TRAIN_BATCH, cfg.image_size, tok,
                                      max_boxes=cfg.max_boxes)
        batch = next(ds.batches(TRAIN_BATCH))
    before = {n: p.detach().clone() for n, p in learner.model.named_parameters()}
    runs = {}
    with deterministic():
        for mode in ("eager", "captured"):
            with torch.no_grad():
                for name, p in learner.pools.items():
                    p.copy_(before[name])
            step = learner.make_step(TRAIN_TASK, steps_per_epoch=n_steps,
                                     epochs=cfg.epochs_per_task,
                                     eager=mode == "eager")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(dk, fk)
            losses, times = [], []
            for i in range(1 + n_steps):
                if i == 1 and mode == "eager":
                    reset_counts(dk, fk)
                t = time.perf_counter()
                metrics = step(batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
                losses.append({k: v.item() for k, v in metrics.items()})
                for k, v in losses[-1].items():
                    if not np.isfinite(v):
                        raise AssertionError(f"train step {i} ({mode}): {k} = {v}")
            peak = torch.cuda.max_memory_allocated()
            launches = launch_counts(dk, fk)
            # the counters count host calls: the steps after the first
            # eagerly; the warm-up and the capture when captured (a replay
            # makes no host call)
            calls = n_steps if mode == "eager" else WARMUP + 1
            want = expected_counts(dk, fk, cfg, calls, train=True)
            log(f"train {label} ({mode}): launch counters {launches} over {calls} host calls "
                f"of the step")
            if launches != want:
                raise AssertionError(f"want {want} launches, got {launches}")
            launches.update(check_resize_launches(cfg, calls, True, f"train {label} ({mode})"))
            med = statistics.median(times[1:])
            log(f"train step {label} ({mode}) on {card_line()}: median {med:.3f} ms over "
                f"{n_steps} steps after the first ({times[0]:.3f} ms), "
                f"{1e3 * TRAIN_BATCH / med:.3f} samples/s, all {[round(x, 3) for x in times]}")
            log(f"train {label} ({mode}): total loss first {losses[0]['total']:.6f}, last "
                f"{losses[-1]['total']:.6f}; " + ", ".join(f"{k} {v:.6f}"
                                                          for k, v in losses[-1].items()))
            pools = {n: p.detach().clone() for n, p in learner.pools.items()}
            stats = per_step = None
            if mode == "captured" or profile_eager:
                kernels, stats = _profile(lambda: step(batch), f"train step ({label}, {mode})")
                log_deform_kernels(kernels)
                per_step = check_replay_launches(dk, fk, cfg, kernels, True,
                                                 f"train {label} ({mode})")
                per_step.update(check_resize_replay(cfg, kernels, True,
                                                    f"train {label} ({mode})"))
                if route == "fused":
                    record_fused_split(kernels, records,
                                       expected_counts(dk, fk, cfg, 1, train=True))
            runs[mode] = dict(losses=losses, pools=pools, med=med, peak=peak, stats=stats,
                              launches=launches, per_step=per_step)
            del step
    same_bits(runs, f"train {label}")
    mode_summary(runs, f"train step {label}", TRAIN_BATCH)
    for name, n in runs["eager"]["launches"].items():
        if name in records and n:
            records[name]["launches"] = n
            records[name]["replay_launches_per_step"] = runs["captured"]["per_step"][name]

    changed = 0
    for name, p in learner.model.named_parameters():
        old = before[name]
        if name in learner.pools:
            others = [i for i in range(cfg.total_tasks) if i != TRAIN_TASK]
            if not torch.equal(p[others], old[others]):
                raise AssertionError(f"{name}: rows other than task {TRAIN_TASK} moved")
            changed += not torch.equal(p[TRAIN_TASK], old[TRAIN_TASK])
        elif not torch.equal(p, old):
            raise AssertionError(f"frozen parameter {name} moved")
    if changed == 0:
        raise AssertionError(f"no pool row of task {TRAIN_TASK} moved")
    log(f"train {label}: frozen parameters and the other tasks' pool rows bit-identical; "
        f"{changed} of {len(learner.pools)} pool leaves moved their task-{TRAIN_TASK} row")
    model = learner.model if keep_model else None
    del before, learner, runs
    torch.cuda.empty_cache()
    return (batch, model) if keep_model else batch


def record_fused_split(kernels, records, calls):
    """The fused kernels' device ms in one profiled train step, by kernel,
    into the records (`step_split_ms`): one forward kernel, one U product
    and one sample launch per wrapper call, and no d W (the continual
    step's head is frozen)."""
    times = fused_kernel_times(kernels)
    n = calls["fused_deform"]
    want = {"fused_fwd_kernel": n, "u_product_kernel": n, "fused_bwd_sample_kernel": n}
    got = {name: count for name, (count, _) in times.items()}
    if got != want:
        raise AssertionError(f"profiled fused step: kernel launches {got}, want {want}")
    records["fused_deform"]["step_split_ms"] = {"fused_fwd_kernel": times["fused_fwd_kernel"][1]}
    records["fused_deform_backward"]["step_split_ms"] = {
        name: times[name][1] for name in ("u_product_kernel", "fused_bwd_sample_kernel")}


def log_deform_kernels(kernels):
    for key, (n, ms) in sorted(deform_kernel_times(kernels).items()):
        log(f"profile deform kernel {WINDOW_KERNELS[key]}: {ms:.3f} ms device, x{n}")
    for name, (n, ms) in sorted(fused_kernel_times(kernels).items()):
        log(f"profile fused deform kernel {name}: {ms:.3f} ms device, x{n}")


def rel_frob(a, b) -> float:
    """Relative Frobenius error of a against b."""
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def hold_leaves(ours, theirs, what, rel=1e-4):
    """Each pool leaf's gradient on its own within relative Frobenius `rel`
    (a concatenation lets the largest leaf hide a wrong small one). ->
    the leaves over the bar, with their errors."""
    errs = {n: rel_frob(ours[n], theirs[n]) for n in sorted(theirs)}
    for n, e in errs.items():
        log(f"fp32 card vs cpu {what} grad {n}: norm {np.linalg.norm(ours[n]):.3e}, "
            f"rel frobenius {e:.3e} (bar {rel})")
    return {n: e for n, e in errs.items() if not e <= rel}


def _floating(out) -> bool:
    return isinstance(out, torch.Tensor) and out.is_floating_point()


def outputs_recorded(outputs):
    """A forward hook for every module that appends each call's floating
    tensor output to `outputs`."""
    def record(module, args, out):
        if _floating(out):
            outputs.append(out.detach().clone())
    return record


def outputs_pinned(card_outputs):
    """A forward hook for every module that hands each call the card's
    output (`card_outputs`, in call order) in place of its own: its own
    plus a constant, so that the gradient flowing back through it is its
    own. Each module's backward then runs at the card's operating point, on
    the card's side of every kink. -> (hook, each call's largest difference
    relative to the card's largest value), the list filled as it runs."""
    calls = iter(card_outputs)
    worst = []

    def pin(module, args, own):
        if not _floating(own):
            return None
        card = next(calls).to(own.device)
        worst.append(float((card - own).detach().abs().max() / max(card.abs().max(), 1e-30)))
        return own + (card - own).detach()

    return pin, worst


def _grounding_grads(cfg32, one, device, hook=None):
    """One fp32 `_losses` at task 1 and the gradient of the task-1 pool rows
    from the seeded weights on `device`; `hook` is put on every module. ->
    (losses, {leaf: gradient}), host values."""
    from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
    from lpi_tpu_torch.continual.keys import exact_fp32

    learner = GroundingLearner(cfg32, generator=torch.Generator().manual_seed(0), device=device)
    handles = [m.register_forward_hook(hook) for m in learner.model.modules()
               if hook is not None]
    t = time.perf_counter()
    try:
        with exact_fp32():
            total, metrics = learner._losses(learner.to_device(one), TRAIN_TASK)
            names = sorted(learner.pools)
            grads = torch.autograd.grad(total, [learner.pools[n] for n in names])
    finally:
        for h in handles:
            h.remove()
    log(f"fp32 losses + backward ({cfg32.dyhead.deform_impl}) on {device}: "
        f"{time.perf_counter() - t:.3f} s")
    return ({k: v.item() for k, v in metrics.items()} | {"total": total.item()},
            {n: g[TRAIN_TASK].double().cpu().numpy() for n, g in zip(names, grads)})


def gradient_phase(cfg, batch):
    """Phase 6 (and 5b's, 13d): one fp32 `_losses` at task 1 and the
    gradient of the task-1 rows of the pools, at batch 1, on the card and
    on the CPU (plain versions), from the same seeded weights: each loss
    term, the concatenated gradient and each leaf's within the repo's bar,
    relative Frobenius 1e-4. The network is piecewise linear in places (the
    deformable convs' hat weights, DyReLU's max, the clips), and an
    argument within a rounding of a kink lands on either side on the two
    devices: a small leaf's gradient then moves by far more than a
    rounding (`scripts/torch_grad_where.py` finds where). A leaf over the
    bar is read again with every module's output on the CPU set to the
    card's (its own plus a constant, so its gradients stay its own; each
    within 1e-3 of the call's largest value): each backward then runs at
    the card's operating point, and the leaf must hold. (From trained
    weights with the scaled offset convs the fp32 gradient moves by 1e-3
    to 1e-2 between two summation orders, on the CPU alone;
    `scripts/torch_grad_order.py` measures that.)"""
    cfg32 = dataclasses.replace(cfg, dtype="float32", batch_size=1)
    one = {k: v[:1] for k, v in batch.items()}
    outputs = []  # the card's module outputs, in call order
    m_gpu, g_gpu = _grounding_grads(cfg32, one, "cuda", outputs_recorded(outputs))
    m_cpu, g_cpu = _grounding_grads(cfg32, one, "cpu")
    if m_gpu["num_pos"] != m_cpu["num_pos"]:
        raise AssertionError(f"num_pos differs: {m_gpu['num_pos']} vs {m_cpu['num_pos']}")
    for k in sorted(m_cpu):
        if k == "num_pos":
            continue
        if not np.isfinite(m_gpu[k]):
            raise AssertionError(f"fp32 {k} not finite on the card")
        assert_close(m_gpu[k], m_cpu[k], k, atol=np.inf)
    assert_close(np.concatenate([g_gpu[n].ravel() for n in sorted(g_gpu)]),
                 np.concatenate([g_cpu[n].ravel() for n in sorted(g_cpu)]),
                 f"task-{TRAIN_TASK} pool gradient", atol=np.inf)
    over = hold_leaves(g_gpu, g_cpu, f"[{TRAIN_TASK}]")
    if not over:
        return
    log(f"fp32 card vs cpu: {sorted(over)} over the bar; the cpu again with every module's "
        f"output set to the card's")
    pin, worst = outputs_pinned(outputs)
    del outputs
    _, g_pin = _grounding_grads(cfg32, one, "cpu", pin)
    log(f"fp32 card vs cpu module outputs: {len(worst)} calls, the largest difference "
        f"{max(worst):.3e} of the card's largest value (bar 1e-3)")
    if not max(worst) <= 1e-3:
        raise AssertionError("the card's module outputs are not the cpu's: the re-read would "
                             "take the cpu's gradient at another point")
    still = hold_leaves({n: g_gpu[n] for n in over}, {n: g_pin[n] for n in over},
                        f"[{TRAIN_TASK}] at the card's module outputs")
    if still:
        raise AssertionError(f"task-{TRAIN_TASK} pool gradient of {sorted(still)}: card and "
                             f"cpu disagree")


def detection_rows(result):
    """A reply's detections as a sorted list of (entity, score, box): the
    predictor test compares detections as sets."""
    return sorted((e, float(s), tuple(float(v) for v in b))
                  for e, s, b in zip(result["entities"], result["scores"], result["boxes"]))


def predict_phase(dk, fk, model, keys, tok, cfg, image, caption, n_req=5, profile=True,
                  classes=None):
    """Phases 3, 3b, 14a and 14c: 1 + `n_req` requests to a bf16 predictor
    of `model` on the card, eager and captured (the first captured request
    warms up and captures its graphs): the launch counters, one request
    profiled with its deform launches by kernel name (unless not
    `profile`), the median latency and peak memory of each mode, equal task
    ids and equal detections. Each request is `predict(image, caption)`,
    or with `classes`, a (class names, knowledge) pair, GLIP-KNOW's
    `predict_classes` (knowledge type "def_wiki"), whose reply has no task
    id. -> (the captured predictor, the eager launch counters over `n_req`
    requests, the replay's deform launches per request, or None)."""
    from lpi_tpu_torch.graphs import WARMUP
    from lpi_tpu_torch.serve.predictor import GroundingPredictor

    what = f"predict {cfg.dyhead.deform_impl}" if classes is None else "predict_classes"
    # random weights score every box near the 0.01 prior: drop the pre-NMS
    # threshold so that all candidates reach NMS and the reply is not empty
    atss = dataclasses.replace(cfg.atss, inference_thresh=0.0)
    results, medians = {}, {}
    for mode in ("eager", "captured"):
        predictor = GroundingPredictor(model, keys, tok, image_size=cfg.image_size,
                                       score_thresh=0.0, atss_cfg=atss, device="cuda",
                                       eager=mode == "eager")

        def request():
            if classes is None:
                return predictor.predict(image, caption)
            return predictor.predict_classes(image, classes[0], classes[1],
                                             knowledge_type="def_wiki")

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(dk, fk)
        t = time.perf_counter()
        request()
        first = (time.perf_counter() - t) * 1e3
        if mode == "eager":
            reset_counts(dk, fk)
        lat = []
        for _ in range(n_req):
            t = time.perf_counter()
            result = request()
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
        launches = launch_counts(dk, fk)
        calls = n_req if mode == "eager" else WARMUP + 1
        log(f"{what} ({mode}): launch counters {launches} over {calls} host calls "
            f"of the forward")
        want = expected_counts(dk, fk, cfg, calls, train=False)
        if launches != want:
            raise AssertionError(f"{what} ({mode}): want {want} launches, got {launches}")
        launches.update(check_resize_launches(cfg, calls, False, f"{what} ({mode})"))
        boxes, scores = result["boxes"], result["scores"]
        names_ok = (0 <= result["task_id"] < cfg.total_tasks if classes is None
                    else set(result["entities"]) <= set(classes[0]))
        if not (boxes.ndim == 2 and boxes.shape[1] == 4 and len(boxes) == len(scores)
                == len(result["entities"]) and len(boxes) > 0
                and np.isfinite(boxes).all() and np.isfinite(scores).all() and names_ok):
            raise AssertionError(f"bad {what} output ({mode}): {result}")
        log(f"{what} ({mode}): entities {sorted(set(result['entities']))}, "
            f"{len(boxes)} boxes, top score {float(scores.max()):.4f}, "
            f"task_id {result.get('task_id')}")
        medians[mode] = statistics.median(lat)
        log(f"{what} latency ({mode}) on {card_line()}: median "
            f"{medians[mode]:.3f} ms over {n_req} requests after the first "
            f"({first:.3f} ms), all {[round(x, 3) for x in lat]}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        per_request = None
        if profile:
            kernels, stats = _profile(request, f"{what} request ({mode})")
            log_deform_kernels(kernels)
            per_request = check_replay_launches(dk, fk, cfg, kernels, False,
                                                f"{what} ({mode})")
            per_request.update(check_resize_replay(cfg, kernels, False, f"{what} ({mode})"))
        results[mode] = result
        if mode == "eager":
            eager_launches = launches
    if results["captured"].get("task_id") != results["eager"].get("task_id"):
        raise AssertionError(f"{what}: task ids differ, captured "
                             f"{results['captured']['task_id']}, eager "
                             f"{results['eager']['task_id']}")
    if detection_rows(results["captured"]) != detection_rows(results["eager"]):
        raise AssertionError(f"{what}: captured and eager detections differ")
    log(f"{what}: captured and eager give task id {results['eager'].get('task_id')} and "
        f"the same {len(results['eager']['boxes'])} detections; median "
        f"{medians['captured']:.3f} ms captured against {medians['eager']:.3f} ms eager")
    return predictor, eager_launches, per_request


def fp32_heads(model, cfg32, keys, canvas, ids, mask, device):
    """The fp32 copy of `model` on `device` at `cfg32` (which may have fewer
    head towers than `model`: the copy takes the first ones): task id and
    head outputs of one image, TF32 off."""
    from lpi_tpu_torch.continual.keys import exact_fp32, infer_task_ids
    from lpi_tpu_torch.models.glip.grounding import GroundedVLModel

    m32 = GroundedVLModel(cfg32)
    missing, _ = m32.load_state_dict(model.state_dict(), strict=False)
    if missing:
        raise AssertionError(f"fp32 copy: {len(missing)} parameters not in the model, "
                             f"{missing[:3]}")
    m32 = m32.to(device).eval()
    t = time.perf_counter()
    with torch.no_grad(), exact_fp32():
        images = torch.from_numpy(canvas).to(device)
        sel = infer_task_ids(m32.extract_features(images), keys.to(device))
        flat, _ = m32.forward_tasks(images, torch.from_numpy(ids).long().to(device),
                                    torch.from_numpy(mask).to(device), sel)
    out = {k: flat[k].float().cpu().numpy() for k in ("dot_logits", "bbox_pred", "centerness")}
    out["task_id"] = int(sel[0])
    log(f"fp32 forward ({cfg32.dyhead.deform_impl}) on {device}: "
        f"{time.perf_counter() - t:.3f} s, task_id {out['task_id']}")
    for k in ("dot_logits", "bbox_pred", "centerness"):
        if not np.isfinite(out[k]).all():
            raise AssertionError(f"fp32 {k} not finite on {device}")
    return out


def compare_heads(ours, theirs, where):
    for k in ("dot_logits", "bbox_pred", "centerness"):
        assert_close(ours[k], theirs[k], k, where=where)
    if ours["task_id"] != theirs["task_id"]:
        raise AssertionError(f"task_id differs ({where})")


def _gate(kind):
    """One quality gate under deterministic algorithms, from counters at 0:
    "pallas" or "fused" (the grounding gate on that route) or "retrieval".
    -> (its values, seconds, the kernel launches it made)."""
    from lpi_tpu_torch.bench import bench_quality_grounding, bench_quality_retrieval
    from lpi_tpu_torch.ops import deform_window_kernel as dk
    from lpi_tpu_torch.ops import fused_deform_kernel as fk

    reset_counts(dk, fk)
    t = time.perf_counter()
    out = (bench_quality_retrieval("cuda") if kind == "retrieval"
           else bench_quality_grounding(device="cuda", deform_impl=kind))
    return out, time.perf_counter() - t, {k: v for k, v in launch_counts(dk, fk).items() if v}


def _gate_child(kind, conn):
    """`_gate` in a child process; its result, or the traceback of its
    failure, goes back through `conn`."""
    import traceback

    try:
        conn.send(_gate(kind))
    except BaseException:
        conn.send(traceback.format_exc())
    finally:
        conn.close()


def gate_phase():
    """Phases 7 and 10: the quality gates, each held to its bars. The
    grounding gate with its own config ("pallas": the window kernels at
    Cout = 16) runs here; the one on the fused route (whose full-parameter
    pretrain runs the d W path) and the retrieval gate (no deform kernel)
    run at the same time in two child processes on the same card. All three
    are host-bound and measure no time but their own seconds, which the
    sharing lengthens."""
    import multiprocessing

    from lpi_tpu_torch.bench import (QUALITY_BARS, RETRIEVAL_BARS, quality_ok,
                                     retrieval_quality_ok)

    ctx = multiprocessing.get_context("spawn")
    children = {}
    try:
        for kind in ("fused", "retrieval"):
            ours, theirs = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=_gate_child, args=(kind, theirs), daemon=True)
            proc.start()
            theirs.close()
            children[kind] = (proc, ours)
        results = {"pallas": _gate("pallas")}
        for kind, (proc, ours) in children.items():
            try:
                results[kind] = ours.recv()
            except EOFError:
                raise AssertionError(f"gate {kind}: the child process ended with "
                                     f"code {proc.exitcode} and no result") from None
            proc.join()
            if isinstance(results[kind], str):
                raise AssertionError(f"gate {kind} failed in its child process:\n"
                                     f"{results[kind]}")
    finally:
        for proc, _ in children.values():
            if proc.is_alive():
                proc.terminate()
            proc.join()
    for route in ("pallas", "fused"):
        out, secs, launches = results[route]
        log(f"gate {route} on {card_line()}: P@1 {out['grounding_p1']}, P@5 "
            f"{out['grounding_p5']}, task-ID accuracy {out['grounding_task_id_acc']}, "
            f"forgetting {out['grounding_forgetting']} in {secs:.3f} s; launches {launches}")
        used = ({"fused_deform", "fused_deform_backward", "fused_deform_backward.dw"}
                if route == "fused" else {"window_accumulate_taps_inpad",
                                          "window_accumulate_taps_s2",
                                          "window_accumulate_taps_inpad_backward",
                                          "window_accumulate_taps_s2_backward"})
        if set(launches) != used:
            raise AssertionError(f"gate {route}: launches {launches}, want {sorted(used)}")
        if not quality_ok(out):
            raise AssertionError(f"gate {route}: {out} misses the bars {QUALITY_BARS}")
    out, secs, launches = results["retrieval"]
    log(f"retrieval gate on {card_line()} in {secs:.3f} s: "
        + ", ".join(f"{k} {v} (JAX package on a TPU: {RETRIEVAL_GATE_TPU[k]})"
                    for k, v in out.items()))
    if launches:
        raise AssertionError(f"retrieval gate launched deform kernels: {launches}")
    if not retrieval_quality_ok(out):
        raise AssertionError(f"retrieval gate: {out} misses the bars {RETRIEVAL_BARS}")


def _launched_once(fn, *args):
    """`fn(*args)`, synchronised, checking that it counted one launch."""
    before = fn.launches
    out = fn(*args)
    torch.cuda.synchronize()
    if fn.launches != before + 1:
        raise AssertionError(f"{fn.__name__}: {fn.launches - before} launches for one call")
    return out


def check_padded_kernels(dk, gen, records):
    """Phase 8a: rows 3 and 4 (the pre-padded sums), forward and backward,
    against their plain versions at the microbenchmark's P3 shape and at odd
    ones, with the bars of `_held` (a bf16 d hp plus half a bf16 step); one
    launch per call, and two backward calls equal bit for bit."""
    for B, Ho, Wo, Cout, taps, m in PADDED_CASES:
        for K_ in (taps, 1):
            oy, ox, gate = offset_inputs(gen, B, Ho, Wo, K_, m)
            for dtype in (torch.float32, torch.bfloat16) if K_ > 1 else (torch.float32,):
                hp = torch.randn(B, Ho + 2 * m + 1, Wo + 2 * m + 1, K_ * Cout, device="cuda",
                                 generator=gen).to(dtype)
                ct = torch.randn(B, Ho, Wo, Cout, device="cuda", generator=gen)
                if K_ > 1:
                    name, args = "window_accumulate_taps", (hp, oy, ox, gate)
                    fwd_args, bwd_args = (*args, m, K_), (*args, ct, m, K_)
                    ref_bwd_args = (hp.float(), oy, ox, gate, ct, m, K_)
                else:
                    name, args = "window_accumulate", (hp, oy[:, 0], ox[:, 0])
                    fwd_args, bwd_args = (*args, m), (*args, ct, m)
                    ref_bwd_args = (*args, ct, m)
                fwd, bwd = getattr(dk, name), getattr(dk, f"{name}_backward")
                label = f"{name} {str(dtype)[6:]} b{B} out {Ho}x{Wo} Cout {Cout} K {K_} m {m}"
                err = _held(label, _launched_once(fwd, *fwd_args),
                            getattr(dk, f"{name}_reference")(*fwd_args))
                records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
                got = _launched_once(bwd, *bwd_args)
                if not all(torch.equal(a, b) for a, b in zip(got, _launched_once(bwd, *bwd_args))):
                    raise AssertionError(f"{label}: two backward calls differ")
                if got[0].dtype != dtype or got[0].shape != hp.shape:
                    raise AssertionError(f"{label}: d hp is {got[0].dtype} {tuple(got[0].shape)}")
                want = getattr(dk, f"{name}_backward_reference")(*ref_bwd_args)
                errs = []
                for what, a, b in zip(("dhp", "doy", "dox", "dgate"), got, want):
                    bf16 = what == "dhp" and dtype == torch.bfloat16
                    errs.append(_held(f"{label} {what}", a, b, bf16=bf16))
                    if not bf16:
                        rec = records[f"{name}_backward"]
                        rec["max_abs_err"] = max(rec["max_abs_err"], errs[-1])
                log(f"kernel {label}: forward max abs err {err:.3e}; backward "
                    + ", ".join(f"{w} {e:.3e}" for w, e in zip(("dhp", "doy", "dox", "dgate"),
                                                               errs)) + "; repeats bit for bit")


def grid_sample_inputs(hp, oy, ox, m: int):
    """`window_accumulate` as one `grid_sample` call: hp as [B, C, Hp, Wp]
    and the grid (x, y) at (x + m + ox, y + m + oy), normalised for
    align_corners=True. With offsets in [-m, m] every sample lies inside
    the map, so bilinear sampling with zero padding is the same function."""
    B, Hp, Wp, _ = hp.shape
    Ho, Wo = oy.shape[1], oy.shape[2]
    ys = torch.arange(Ho, device=hp.device, dtype=torch.float32).view(1, Ho, 1) + m + oy
    xs = torch.arange(Wo, device=hp.device, dtype=torch.float32).view(1, 1, Wo) + m + ox
    grid = torch.stack((2 * xs / (Wp - 1) - 1, 2 * ys / (Hp - 1) - 1), dim=-1)
    return hp.permute(0, 3, 1, 2), grid.contiguous()


def padded_records(dk, results, records):
    """Phase 8c: the records of rows 3 and 4 at P3 of 448 px, batch 4, the
    spread offsets (row 3 with a bf16 map): the kernel's device time from
    the microbenchmark, the plain version's on the same inputs, the bound
    from these inputs, and for row 4 one `grid_sample` call (forward, and
    its backward through `torch.autograd.grad`)."""
    import torch.nn.functional as F

    from lpi_tpu_torch.profile_deform import padded_inputs

    side, Cout = 56, 256
    hp, gate, _, o = padded_inputs(TRAIN_BATCH, side, side, Cout, M, K, torch.bfloat16)
    ct = torch.ones(TRAIN_BATCH, side, side, Cout, device="cuda")
    bench = results["window_accumulate_taps"]["bfloat16"]["spread"]
    cases = [("window_accumulate_taps", bench["fwd"]["ms"], window_bound_ms(hp, o, Cout),
              lambda: dk.window_accumulate_taps_reference(hp, o, o, gate, M, K)),
             ("window_accumulate_taps_backward", bench["bwd"]["ms"],
              window_bound_ms(hp, o, Cout, backward=True),
              lambda: dk.window_accumulate_taps_backward_reference(hp, o, o, gate, ct, M, K))]
    hp1, _, _, o1 = padded_inputs(TRAIN_BATCH, side, side, Cout, M, 1, torch.float32)
    o1 = o1[:, 0]
    bench = results["window_accumulate"]["spread"]
    cases += [("window_accumulate", bench["fwd"]["ms"], window_bound_ms(hp1, o1, Cout, maps=2),
               lambda: dk.window_accumulate_reference(hp1, o1, o1, M)),
              ("window_accumulate_backward", bench["bwd"]["ms"],
               window_bound_ms(hp1, o1, Cout, maps=2, backward=True),
               lambda: dk.window_accumulate_backward_reference(hp1, o1, o1, ct, M))]
    for name, ms, (bms, kind), plain in cases:
        rec = records[name]
        rec.update(ms=ms, plain_ms=device_time_ms(plain, reps=PLAIN_REPS, warmup=1), bound_ms=bms)
        rec["bound_kinds"].add(kind)

    inp, grid = grid_sample_inputs(hp1, o1, o1, M)
    sample = dict(mode="bilinear", padding_mode="zeros", align_corners=True)
    want = dk.window_accumulate_reference(hp1, o1, o1, M)
    got = F.grid_sample(inp, grid, **sample).permute(0, 2, 3, 1)
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    log(f"grid_sample against the plain window_accumulate at P3: max abs err {err:.3e} "
        f"(bar 1e-4 x {scale:.3f}: the grid's normalisation rounds)")
    if not err <= 1e-4 * scale:
        raise AssertionError("grid_sample does not compute window_accumulate")
    records["window_accumulate"]["library_ms"] = device_time_ms(
        lambda: F.grid_sample(inp, grid, **sample))
    # the op `torch.autograd.grad` runs for grid_sample's VJP (bilinear = 0,
    # zeros = 0), called alone: a CUDA graph cannot hold the backward of a
    # forward recorded outside it
    ct_nchw = ct.permute(0, 3, 1, 2)
    vjp = (ct_nchw, inp, grid, 0, 0, True, [True, True])
    records["window_accumulate_backward"]["library_ms"] = device_time_ms(
        lambda: torch.ops.aten.grid_sampler_2d_backward(*vjp))
    d_inp, d_grid = torch.ops.aten.grid_sampler_2d_backward(*vjp)
    dhp, doy, _ = dk.window_accumulate_backward_reference(hp1, o1, o1, ct, M)
    doy_err = (d_grid[..., 1] * 2 / (hp1.shape[1] - 1) - doy).abs()
    integer = o1 == torch.round(o1)
    log(f"grid_sample backward against the plain one at P3: d hp max abs err "
        f"{(d_inp.permute(0, 2, 3, 1) - dhp).abs().max().item():.3e}; d oy max abs err "
        f"{doy_err[~integer].max().item():.3e} off the integer offsets and "
        f"{doy_err[integer].amax().item() if integer.any() else 0.0:.3e} at the "
        f"{int(integer.sum())} integer ones (grid_sample's derivative there is not the "
        f"Pallas VJP's 0)")
    for name in ("window_accumulate_taps", "window_accumulate_taps_backward",
                 "window_accumulate", "window_accumulate_backward"):
        rec = records[name]
        lib = rec["library_ms"]
        log(f"record {name} at P3, b{TRAIN_BATCH}: {rec['ms']:.6f} ms, plain "
            f"{rec['plain_ms']:.6f} ms, bound {rec['bound_ms']:.6f} ms, library "
            + ("none (no one call computes it)" if lib is None else f"{lib:.6f} ms"))


def microbenchmark_phase(dk, fk, gen, records):
    """Phase 8: rows 3 and 4 against their plain versions (8a), then their
    path, the deform-window microbenchmark `lpi_tpu_torch.profile_deform`,
    driven with every counter set to 0 just before and read just after
    (8b), then the records (8c)."""
    from lpi_tpu_torch import profile_deform

    check_padded_kernels(dk, gen, records)
    reset_counts(dk, fk)
    results = profile_deform.profile(log)
    launches = {k: v for k, v in launch_counts(dk, fk).items() if v}
    log(f"microbenchmark: launches {launches}")
    # bench_conv runs the stride-1 window sums and the fused conv too
    used = {*PADDED_KERNELS, "window_accumulate_taps_inpad",
            "window_accumulate_taps_inpad_backward", "fused_deform", "fused_deform_backward"}
    if set(launches) != used:
        raise AssertionError(f"microbenchmark: launches {launches}, want {sorted(used)}")
    for name in PADDED_KERNELS:
        records[name]["launches"] = launches[name]
    padded_records(dk, results, records)


# the retrieval quality gate's values from the JAX package on a TPU
# (`BENCH_r05.json`): quality figures to compare with, not times
RETRIEVAL_GATE_TPU = {"txt_r1": 75.0, "img_r1": 95.8, "i2t_p1_average": 75.0,
                      "task_id_acc_visual": 0.875, "task_id_acc_textual": 1.0,
                      "i2t_forgetting": 6.2}
RETRIEVAL_STEPS = 10
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak of an H100 SXM (NVIDIA's data sheet)
# device kernels by kind, first match wins: products, then casts and copies,
# then reductions, then other elementwise ops
KERNEL_KINDS = (("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
                ("copy or cast", ("copy",)),
                ("reduction", ("reduce", "softmax", "norm")),
                ("elementwise", ("elementwise",)))


def retrieval_step_flops(cfg) -> int:
    """Operations of the towers' products in one train step: the forward,
    then the gradients of the activations only (the towers' weights take no
    gradient, the images none): each linear layer once more, each attention
    product twice more; the patch stem forward only. Per token and layer
    the linear layers are 24 D^2 (q, k, v, out, the 4x MLP), per sequence
    and layer the attention 4 S^2 D. Elementwise ops are not counted."""
    c, B = cfg.clip, cfg.batch_size
    patches = (c.image_resolution // c.patch_size) ** 2
    # "lpi" and "sprompts" add their prompt tokens; "l2p" overwrites tokens
    added = cfg.lpi.prompt_length if cfg.lpi.prompt_type in ("lpi", "sprompts") else 0
    linear = attn = 0
    for S, D, L in ((patches + 1 + added, c.vision_width, c.vision_layers),
                    (c.context_length, c.text_width, c.text_layers)):
        linear += L * B * S * 24 * D * D
        attn += L * B * 4 * S * S * D
    stem = B * patches * 2 * 3 * c.patch_size ** 2 * c.vision_width
    if cfg.lpi.prompt_type == "clip":  # its loss reads no pool leaf: no backward
        return linear + attn + stem
    return 2 * linear + 3 * attn + stem


def retrieval_train_phase(dk, fk, cfg=None, steps=RETRIEVAL_STEPS, what="retrieval",
                          profile_eager=True):
    """Phase 9 (and 13a): the full-width continual-retrieval step (SliNet on
    `RetrievalConfig()`: CLIP ViT-B/16 at 224 px, 213 vision tokens, LPI
    prompts; batch 64, bf16; or `cfg`) at task 1 on the bench's inputs,
    1 + `steps` steps of `train_session`'s step eagerly and 1 + `steps`
    captured from the same start: losses finite with the prompt type's
    keys, captured against eager in bits, the current slice of every pool
    leaf moved, every other slice and every tower parameter bit-equal to
    its start, no deform kernel launched; the median step, samples/s, peak
    memory, one profiled step; then `cluster_task` on two small sessions
    and one `evaluate` at full width on a 2-task `synthetic_eval` set (for
    L2P, which has no evaluation, the named error)."""
    from lpi_tpu_torch.bench import retrieval_inputs
    from lpi_tpu_torch.config import RetrievalConfig
    from lpi_tpu_torch.continual.learner import RetrievalLearner
    from lpi_tpu_torch.data.retrieval import synthetic_eval, synthetic_session
    from lpi_tpu_torch.data.tokenizer import ClipTokenizer
    from lpi_tpu_torch.models.clip.slinet import L2P_EVAL_GAP

    from lpi_tpu_torch.bench import deterministic

    cfg = RetrievalConfig() if cfg is None else cfg
    prompt_type = cfg.lpi.prompt_type
    want_keys = {"total", "base_loss"} | ({"alignment_loss", "task_loss"} if prompt_type == "lpi"
                                         else set())
    t = time.perf_counter()
    learner = RetrievalLearner(cfg, generator=torch.Generator().manual_seed(0), device="cuda")
    log(f"{what}: learner built in {time.perf_counter() - t:.3f} s; "
        f"{sum(p.numel() for p in learner.frozen.values())} frozen and "
        f"{sum(p.numel() for p in learner.pools.values())} pool parameters in "
        f"{sorted(learner.pools)}")
    batch = learner.to_device(retrieval_inputs(cfg))
    before = {n: p.detach().clone() for n, p in learner.model.named_parameters()}
    runs = {}
    with deterministic():
        for mode in ("eager", "captured"):
            with torch.no_grad():
                for name, p in learner.pools.items():
                    p.copy_(before[name])
            step = learner.make_train_step(TRAIN_TASK, steps_per_epoch=100, epochs=cfg.epochs,
                                           eager=mode == "eager")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(dk, fk)
            times, losses = [], []
            for i in range(1 + steps):
                t = time.perf_counter()
                metrics = step(batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
                losses.append({k: v.item() for k, v in metrics.items()})
                if set(losses[-1]) != want_keys:
                    raise AssertionError(f"{what} step {i} ({mode}): losses {sorted(losses[-1])}"
                                         f", want {sorted(want_keys)}")
                for k, v in losses[-1].items():
                    if not np.isfinite(v):
                        raise AssertionError(f"{what} step {i} ({mode}): {k} = {v}")
            peak = torch.cuda.max_memory_allocated()
            launches = {k: v for k, v in launch_counts(dk, fk).items() if v}
            if launches:
                raise AssertionError(f"{what} step launched deform kernels: {launches}")
            med = statistics.median(times[1:])
            log(f"{what} step ({mode}) on {card_line()}: median {med:.3f} ms over "
                f"{steps} steps after the first ({times[0]:.3f} ms), "
                f"{1e3 * cfg.batch_size / med:.3f} samples/s, all {[round(x, 3) for x in times]}")
            log(f"{what} step ({mode}): " + ", ".join(f"{k} {v:.6f}"
                                                     for k, v in losses[-1].items()))
            pools = {n: p.detach().clone() for n, p in learner.pools.items()}
            kernels = stats = None
            if mode == "captured" or profile_eager:
                kernels, stats = _profile(lambda: step(batch), f"{what} train step ({mode})")
            runs[mode] = dict(losses=losses, pools=pools, med=med, peak=peak, stats=stats,
                              kernels=kernels)
            del step
    same_bits(runs, f"{what} step")
    mode_summary(runs, f"{what} step", cfg.batch_size)
    moved = 0
    for name, p in learner.model.named_parameters():
        old = before[name]
        if name in learner.pools:
            others = [i for i in range(cfg.total_sessions) if i != TRAIN_TASK]
            if not torch.equal(p[others], old[others]):
                raise AssertionError(f"{name}: slices other than task {TRAIN_TASK} moved")
            moved += not torch.equal(p[TRAIN_TASK], old[TRAIN_TASK])
        elif not torch.equal(p, old):
            raise AssertionError(f"tower parameter {name} moved")
    if moved != len(learner.pools):
        raise AssertionError(f"{moved} of {len(learner.pools)} pool leaves moved their "
                             f"task-{TRAIN_TASK} slice")
    log(f"{what} step: every tower parameter and the other tasks' slices bit-identical; "
        f"all {moved} pool leaves moved their task-{TRAIN_TASK} slice")
    del before
    kernels, med = runs["captured"]["kernels"], runs["captured"]["med"]
    groups = {}
    for e in kernels:
        key = e.key.lower()
        kind = next((k for k, words in KERNEL_KINDS if any(w in key for w in words)), "other")
        n, ms = groups.get(kind, (0, 0.0))
        groups[kind] = (n + e.count, ms + e.self_device_time_total / 1e3)
    log("profile retrieval step by kind: " + ", ".join(
        f"{k} {ms:.3f} ms x{n}" for k, (n, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1])))
    flops = retrieval_step_flops(cfg)
    floor = flops / BF16_FLOPS * 1e3
    busy = sum(ms for _, ms in groups.values())
    gemm = groups.get("gemm", (0, 0.0))[1]
    log(f"{what} step: {flops / 1e12:.3f} TFLOP of tower products, {floor:.3f} ms at the "
        f"bf16 peak: {100 * floor / med:.1f}% of the median step"
        + (f", {100 * floor / busy:.1f}% of the profiled device time, "
           f"{100 * floor / gemm:.1f}% of its products' time" if gemm else ""))

    t = time.perf_counter()
    tok = ClipTokenizer()
    res = cfg.clip.image_resolution
    for task in range(2):
        learner.cluster_task(synthetic_session(task, 16, res, tok, cfg.clip.n_ctx))
    eval_set = synthetic_eval(2, 8, 1, res, tok, cfg.clip.n_ctx)
    if prompt_type == "l2p":
        try:
            learner.evaluate(eval_set, num_tasks=2)
        except NotImplementedError as e:
            if str(e) != L2P_EVAL_GAP:
                raise
            log(f"{what} evaluate: raises the named error, as the reference stops there: {e}")
        else:
            raise AssertionError("L2P evaluate ran: the reference has no such path")
        del learner, batch, runs
        torch.cuda.empty_cache()
        return
    out = learner.evaluate(eval_set, num_tasks=2)
    summary = {k: float(v) for k, v in out["summary"].items()}
    acc = out["task_id_accuracy"]
    if not (set(out["i2t"]) == set(out["t2i"]) == {0, 1}
            and all(np.isfinite(v) and 0 <= v <= 100 for v in summary.values())
            and all(0 <= v <= 1 for v in acc.values())):
        raise AssertionError(f"bad {what} evaluation: {out}")
    if prompt_type == "clip" and acc != {"visual": 0.5, "textual": 0.5}:
        raise AssertionError(f"zero-shot CLIP takes task 0 for every sample: task-ID {acc}")
    log(f"{what} evaluate (random weights, 2 tasks, 16 images, 16 captions): "
        f"{time.perf_counter() - t:.3f} s with the two cluster_task calls; txt R@1 "
        f"{summary['txt_r1']:.1f}, img R@1 {summary['img_r1']:.1f}, task-ID {acc}")
    del learner, batch, runs
    torch.cuda.empty_cache()


def grounding_bench_phase():
    """Phase 11: `lpi_tpu_torch.bench.bench_grounding` on the card (the
    full-width grounding step captured, seeded then honest offsets): both
    keys of the bench line, finite and > 0."""
    from lpi_tpu_torch.bench import bench_grounding

    t = time.perf_counter()
    out = bench_grounding()
    line = {"grounding_train_samples_per_sec_per_chip": round(out["honest_offsets"], 2),
            "grounding_train_samples_per_sec_zero_offsets": round(out["zero_offsets"], 2)}
    log(f"grounding bench on {card_line()} in {time.perf_counter() - t:.3f} s: "
        f"{json.dumps(line)}")
    if not all(np.isfinite(v) and v > 0 for v in out.values()):
        raise AssertionError(f"grounding bench: {out}")
    torch.cuda.empty_cache()


def retrieval_gradient_phase(lpi=None, what="retrieval"):
    """Phase 9b (and 13b): one fp32 `_losses` at task 1 and the gradient of
    the pools (the task-1 slices; every slice of L2P's shared pool, where
    the vote picks the rows), at full width and 2 layers a tower, batch 8
    of the bench's inputs, on the card and on the CPU from the same seeded
    weights, TF32 off: each loss term, the concatenated gradient and each
    leaf's within relative Frobenius 1e-4; L2P's chosen pool entries equal. `lpi`
    replaces the LPI prompt config."""
    from lpi_tpu_torch.bench import retrieval_inputs
    from lpi_tpu_torch.config import RetrievalConfig
    from lpi_tpu_torch.continual.keys import exact_fp32
    from lpi_tpu_torch.continual.learner import RetrievalLearner

    base = RetrievalConfig()
    cfg = dataclasses.replace(base, dtype="float32", batch_size=8, clip=dataclasses.replace(
        base.clip, vision_layers=2, text_layers=2), lpi=lpi or base.lpi)
    l2p = cfg.lpi.prompt_type == "l2p"
    batch = retrieval_inputs(cfg)
    out, chosen = {}, {}
    for device in ("cuda", "cpu"):
        learner = RetrievalLearner(cfg, generator=torch.Generator().manual_seed(0),
                                   device=device)
        t = time.perf_counter()
        with exact_fp32():
            b = learner.to_device(batch)
            total, losses = learner._losses(b, TRAIN_TASK)
            names = sorted(learner.pools)
            grads = torch.autograd.grad(total, [learner.pools[n] for n in names],
                                        allow_unused=True)
            if l2p:
                model = learner.model
                with torch.no_grad():
                    chosen[device] = model.prompts(model.clip.visual.embed(b["images"]))[
                        "prompt_idx"].cpu()
        out[device] = ({k: v.item() for k, v in losses.items()} | {"total": total.item()},
                       {n: (g if l2p else g[TRAIN_TASK]).double().cpu().numpy()
                        for n, g in zip(names, grads) if g is not None})
        log(f"{what} fp32 losses + backward on {device}: {time.perf_counter() - t:.3f} s")
        del learner, grads
    if l2p:
        if not torch.equal(chosen["cuda"], chosen["cpu"]):
            raise AssertionError(f"{what}: L2P chose {chosen['cuda'][0].tolist()} on the card, "
                                 f"{chosen['cpu'][0].tolist()} on the CPU")
        log(f"{what}: L2P's chosen pool entries {chosen['cuda'][0].tolist()} equal on the card "
            f"and the CPU")
    (m_gpu, g_gpu), (m_cpu, g_cpu) = out["cuda"], out["cpu"]
    for k in sorted(m_cpu):
        if not np.isfinite(m_gpu[k]):
            raise AssertionError(f"{what} fp32 {k} not finite on the card")
        assert_close(m_gpu[k], m_cpu[k], f"{what} {k}", atol=np.inf)
    if sorted(g_gpu) != sorted(g_cpu) or not g_gpu:
        raise AssertionError(f"pool gradients present: {sorted(g_gpu)} vs {sorted(g_cpu)}")
    assert_close(np.concatenate([g_gpu[n].ravel() for n in sorted(g_gpu)]),
                 np.concatenate([g_cpu[n].ravel() for n in sorted(g_cpu)]),
                 f"{what} task-{TRAIN_TASK} pool gradient of {sorted(g_gpu)}", atol=np.inf)
    over = hold_leaves(g_gpu, g_cpu, what)
    if over:
        raise AssertionError(f"{what} pool gradient of {sorted(over)}: card and cpu disagree")


# ---- phase 12: the command line, its checkpoints and `restore` ---------------
CLI_BATCH = 16  # `GroundingConfig().batch_size`, the command line's default
CLI_P3 = 56  # P3 of the 448 px head
CLI_CAPTION = "a red car parked next to a tall tree and a small dog"
CLI_WINDOW = ("window_accumulate_taps_inpad", "window_accumulate_taps_s2",
              "window_accumulate_taps_inpad_backward", "window_accumulate_taps_s2_backward")


def check_window_shapes(dk, gen, records, batch, shapes, label):
    """Rows 1f, 2f, 1b and 2b at `batch` (bf16 maps, Cout 256) and each
    input side of `shapes` ({stride: {side: launches}}) against their plain
    versions with the bars of phases 2 and 2b, one launch a call, two calls
    equal bit for bit, each timed (CUDA graphs) beside its bound; the
    errors into the records' `max_abs_err` (d h_all's aside, as in 2b).
    -> {kernel: {"ms", "bound_ms"}}, each summed over its launches."""
    specs = ((1, dk.window_accumulate_taps_inpad, dk.window_accumulate_taps_inpad_reference,
              dk.window_accumulate_taps_inpad_backward,
              dk.window_accumulate_taps_inpad_backward_reference),
             (2, dk.window_accumulate_taps_s2, dk.window_accumulate_taps_s2_reference,
              dk.window_accumulate_taps_s2_backward,
              dk.window_accumulate_taps_s2_backward_reference))
    sums = {}
    for stride, fwd, fwd_ref, bwd, bwd_ref in specs:
        for side, n in shapes[stride].items():
            h, oy, ox, g, ct = kernel_inputs(gen, side, stride, torch.bfloat16, batch)
            args, bargs = (h, oy, ox, g, M, K, KW), (h, oy, ox, g, ct, M, K, KW)
            where = f"{label} b{batch} in {side}x{side}x{K * 256} stride {stride}"
            got = _launched_once(fwd, *args)
            if not torch.equal(got, _launched_once(fwd, *args)):
                raise AssertionError(f"{fwd.__name__} {where}: two calls differ")
            err = _held(f"{fwd.__name__} {where}", got, fwd_ref(*args))
            got = _launched_once(bwd, *bargs)
            if not all(torch.equal(a, b) for a, b in zip(got, _launched_once(bwd, *bargs))):
                raise AssertionError(f"{bwd.__name__} {where}: two calls differ")
            want = bwd_ref(h.float(), oy, ox, g, ct, M, K, KW)
            errs = [_held(f"{bwd.__name__} {where} {what}", a, b, bf16=what == "dh")
                    for what, a, b in zip(("dh", "doy", "dox", "dgate"), got, want)]
            del got, want
            for fn, a, (bound, kind), kernel_errs in (
                    (fwd, args, window_bound_ms(h, oy, 256, offsets=(ox, g, stride, M, KW)),
                     [("out", err)]),
                    (bwd, bargs, window_bound_ms(h, oy, 256, backward=True),
                     list(zip(("dh (bf16)", "doy", "dox", "dgate"), errs)))):
                rec = records[fn.__name__]
                rec["max_abs_err"] = max(rec["max_abs_err"],
                                         *(e for w, e in kernel_errs if w != "dh (bf16)"))
                ms = device_time_ms(lambda: fn(*a), inner=10)
                log(f"kernel {fn.__name__} bf16 {where} on {card_line()}: {ms:.6f} ms, bound "
                    f"{bound:.6f} ms ({kind}; {100 * bound / ms:.1f}% of it), max abs err "
                    f"{', '.join(f'{w} {e:.3e}' for w, e in kernel_errs)}; two calls equal "
                    f"bit for bit; {n} launches")
                total = sums.setdefault(fn.__name__, {"ms": 0.0, "bound_ms": 0.0})
                total["ms"] += n * ms
                total["bound_ms"] += n * bound
            del h, oy, ox, g, ct, args, bargs
    torch.cuda.empty_cache()
    return sums


def run_cli(*argv):
    """`python -m lpi_tpu_torch.cli.main argv`, in this process; what it
    prints goes to a buffer. -> (its return value, wall seconds, the
    printed text)."""
    import io

    from lpi_tpu_torch.cli import main as cli

    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = cli.main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    log(f"cli {argv[0]} on {card_line()}: {wall:.3f} s wall")
    return out, wall, buf.getvalue()


@contextlib.contextmanager
def grounding_head_outputs():
    """Records every eval batch of `GroundingLearner.evaluate`, in order, as
    a digest of the head outputs it hands to the postprocess (box
    regression, centerness, token logits) and the largest |box regression|;
    what the evaluation computes is unchanged. Yields the list it fills."""
    import hashlib

    from lpi_tpu_torch.continual import grounding_learner as gl

    seen, post = [], gl.atss_postprocess_batch

    def record(anchors, level_counts, bbox_pred, centerness, dot_logits, *a, **kw):
        digest = hashlib.sha256()
        for t in (bbox_pred, centerness, dot_logits):
            digest.update(t.detach().float().cpu().numpy().tobytes())
        seen.append((digest.hexdigest(), float(bbox_pred.float().abs().max())))
        return post(anchors, level_counts, bbox_pred, centerness, dot_logits, *a, **kw)

    gl.atss_postprocess_batch = record
    try:
        yield seen
    finally:
        gl.atss_postprocess_batch = post


def cpu_state(tensors) -> dict:
    return {n: t.detach().cpu().clone() for n, t in tensors.items()}


def same_state(got, want, what):
    """Equal names and equal bits."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: entries differ, {sorted(set(got) ^ set(want))[:5]}")
    for n in want:
        g = got[n].detach().cpu()
        if g.dtype != want[n].dtype or not torch.equal(g, want[n]):
            raise AssertionError(f"{what}: {n} differs")


def reseeded(work) -> str:
    """A `--config` json that seeds both learners' initial parameters with
    99, not the default seeds that the training commands used."""
    path = os.path.join(work, "reseeded.json")
    with open(path, "w") as f:
        json.dump({"retrieval": {"seed": 99}, "grounding": {"seed": 99}}, f)
    return path


def train_metrics(directory, batch):
    """Each session's train metrics from the command's metrics.jsonl, every
    value finite; -> [(session, steps/s, total loss)]."""
    out = []
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        for rec in map(json.loads, f):
            bad = {k: v for k, v in rec.items() if not np.isfinite(v)}
            if bad:
                raise AssertionError(f"non-finite train metrics {bad}")
            out.append((int(rec.get("session", rec.get("task", -1))),
                        rec["samples_per_sec"] / batch, rec["total"]))
    return out


def as_json(x):
    return json.loads(json.dumps(x, default=float))


def resume_through_capture(learner, ckpt, first, second, make, train, keys_of, want, what):
    """A fresh `learner` captures its step at task 0 and takes one step,
    restores session 0 of `ckpt`, then trains task 1 (`train(second)`):
    its pools and task keys (`keys_of(learner)`) must equal `want` (the
    uninterrupted run's after task 1) bit for bit, every parameter keeping
    its storage."""
    from lpi_tpu_torch.bench import deterministic

    with deterministic():
        make(0)(first)
        ptrs = {n: p.data_ptr() for n, p in learner.model.named_parameters()}
        learner.restore(ckpt, 0)
        train(second)
    torch.cuda.synchronize()
    if len(learner._graphs) != 1:
        raise AssertionError(f"{what}: {len(learner._graphs)} captures, want 1")
    if ptrs != {n: p.data_ptr() for n, p in learner.model.named_parameters()}:
        raise AssertionError(f"{what}: restore moved a parameter's storage")
    same_state(cpu_state(learner.pools), want["pools"], f"{what} pools")
    same_state(keys_of(learner), want["keys"], f"{what} task keys")
    log(f"{what}: a step captured at task 0, then restore of session 0 and task 1 through "
        f"the same capture: {len(want['pools'])} pool leaves and the task keys equal the "
        f"uninterrupted run's bit for bit")


def cli_grounding_phase(dk, fk, records, work):
    """Phases 12b-12e and 12g: `train-grounding --synthetic --tasks 2
    --epochs 1` at `GroundingConfig()` (full GLIP-T + LPI, 448 px, bf16,
    batch 16, "pallas"); its checkpoint's size and save and load times, and
    the checkpoint loaded on the CPU bit for bit; `eval-all --grounding`
    equal to the training run's numbers; `predict` from the checkpoint
    equal to a predictor on the learner that wrote it; resume through a
    captured step."""
    from PIL import Image

    from lpi_tpu_torch.bench import deterministic
    from lpi_tpu_torch.config import GroundingConfig
    from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
    from lpi_tpu_torch.continual.mid import fallback_sim_matrix
    from lpi_tpu_torch.core.checkpoint import SessionCheckpointer
    from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
    from lpi_tpu_torch.data.grounding import synthetic_grounding_task
    from lpi_tpu_torch.serve.predictor import GroundingPredictor

    cfg = GroundingConfig()
    ck, res_dir = os.path.join(work, "ckpt_grounding"), os.path.join(work, "res_grounding")
    reset_counts(dk, fk)
    with grounding_head_outputs() as trained:
        (path, learner), wall, _ = run_cli("train-grounding", "--synthetic", "--tasks", "2",
                                           "--epochs", "1", "--output-dir", res_dir,
                                           "--checkpoint-dir", ck)
    launches = {k: v for k, v in launch_counts(dk, fk).items() if v}
    log(f"cli train-grounding: launch counters {launches} (host calls: the capture's warm-up "
        f"and capture, cluster_task and evaluate; replays make none)")
    if set(launches) != set(CLI_WINDOW):
        raise AssertionError(f"train-grounding launched {launches}, want each of {CLI_WINDOW}")
    for name in CLI_WINDOW:
        records[name]["cli_launches"] = launches[name]
    for session, steps, total in train_metrics(res_dir, cfg.batch_size):
        log(f"cli train-grounding task {session} on {card_line()}: {steps:.3f} steps/s "
            f"(batch {cfg.batch_size}; task 0's steps include the capture), total loss "
            f"{total:.6f}")
    for name in ("base", "session_0", "session_1", "session_0_results.json",
                 "session_1_results.json", "latest"):
        if not os.path.exists(os.path.join(ck, name)):
            raise AssertionError(f"train-grounding wrote no {name}")
    with open(path) as f:
        results = json.load(f)
    def keys_of(lr):
        return cpu_state({"centers": lr.keys.centers, "valid": lr.keys.valid})

    want = {"pools": cpu_state(learner.pools), "keys": keys_of(learner)}

    # 12g: the checkpoint on the CPU, its size, save and load times
    saved = SessionCheckpointer(ck)
    t = time.perf_counter()
    base = saved.load_base()
    state = saved.load_session(1)
    load_s = time.perf_counter() - t
    if any(v.device.type != "cpu" for v in (*base.values(), *state["pool_params"].values())):
        raise AssertionError("a checkpoint entry loaded off the CPU")
    same_state(base, cpu_state(learner.frozen), "checkpoint base on the CPU")
    same_state(state["pool_params"], want["pools"], "checkpoint session 1 on the CPU")
    same_state(state["visual_keys"], want["keys"], "checkpoint keys on the CPU")
    again = SessionCheckpointer(os.path.join(work, "ckpt_timing"))
    t = time.perf_counter()
    again.save_base(learner.frozen)
    base_s = time.perf_counter() - t
    t = time.perf_counter()
    again.save_session(1, learner.pools, visual_keys=learner.keys)
    session_s = time.perf_counter() - t
    size = {name: os.path.getsize(os.path.join(ck, name, "state.pt"))
            for name in ("base", "session_0", "session_1")}
    log(f"checkpoint (GroundingConfig()) on {card_line()}: base {size['base']} bytes, a "
        f"session {size['session_1']} bytes; save from the card: base {base_s:.3f} s, session "
        f"{session_s:.3f} s; load on the CPU (map_location cpu): base + session "
        f"{load_s:.3f} s, every entry bit-equal to the card's")
    del base, state, again

    tok = BertTokenizer(max_len=cfg.bert.max_query_len, vocab_size=cfg.bert.vocab_size)
    image = np.random.RandomState(12).randint(0, 256, size=(480, 640, 3)).astype(np.uint8)
    Image.fromarray(image).save(os.path.join(work, "image.png"))
    atss = dataclasses.replace(cfg.atss, inference_thresh=0.0)
    with deterministic():
        writer = GroundingPredictor(learner.model, learner.keys, tok, image_size=cfg.image_size,
                                    score_thresh=0.0, atss_cfg=atss,
                                    device="cuda").predict(image, CLI_CAPTION)
    del learner
    torch.cuda.empty_cache()

    # 12c: every saved task evaluated again in a fresh learner, seeded
    # differently from the writer, so that only what the checkpoint holds
    # can give the writer's numbers
    with grounding_head_outputs() as again:
        out, _, _ = run_cli("eval-all", "--grounding", "--synthetic", "--checkpoint-dir", ck,
                            "--config", reseeded(work))
    if not trained or [d for d, _ in again] != [d for d, _ in trained]:
        raise AssertionError(f"eval-all --grounding: the head outputs of its {len(again)} eval "
                             f"batches differ from the training run's {len(trained)}")
    if min(m for _, m in trained) <= 0:
        raise AssertionError("the training run's eval gave an all-zero box regression")
    log(f"cli eval-all --grounding (a fresh learner seeded 99): the head outputs of its "
        f"{len(again)} eval batches equal the training run's in bits (largest |box "
        f"regression| per batch {min(m for _, m in trained):.6f} to "
        f"{max(m for _, m in trained):.6f})")
    for s in (0, 1):
        got, rec = as_json(out[s]), results[str(s)]
        if (got["overall"], got["per_task"], got["task_id_accuracy"]) != (
                rec["overall"], rec["per_task"], rec["task_id_accuracy"]):
            raise AssertionError(f"eval-all --grounding task {s}: {got}, trained {rec}")
        log(f"cli eval-all --grounding task {s}: P@1/5/10 {got['overall']}, task-ID "
            f"{got['task_id_accuracy']}, equal to the training run's")

    # 12d: predict from the checkpoint
    pcfg = os.path.join(work, "predict.json")
    with open(pcfg, "w") as f:
        json.dump({"grounding": {"seed": 99, "atss": {"inference_thresh": 0.0}}}, f)
    got, _, _ = run_cli("predict", os.path.join(work, "image.png"), CLI_CAPTION, "--config", pcfg,
                        "--checkpoint-dir", ck, "--thresh", "0",
                        "--output", os.path.join(work, "prediction.png"))
    if not (got["task_id"] == writer["task_id"] and got["entities"] == writer["entities"]
            and len(got["boxes"]) > 0 and np.array_equal(got["boxes"], writer["boxes"])
            and np.array_equal(got["scores"], writer["scores"])):
        raise AssertionError("predict from the checkpoint differs from the writer's predictor")
    log(f"cli predict: task id {got['task_id']} and {len(got['boxes'])} detections equal to "
        f"the writer's predictor bit for bit")
    torch.cuda.empty_cache()

    # 12e: resume through a captured step
    learner = GroundingLearner(cfg, task_sim_matrix=fallback_sim_matrix(cfg.total_tasks),
                               device="cuda")
    sets = {t: synthetic_grounding_task(t, max(cfg.batch_size * 2, 8), cfg.image_size, tok,
                                        cfg.max_boxes) for t in (0, 1)}
    resume_through_capture(
        learner, SessionCheckpointer(ck), next(sets[0].batches(cfg.batch_size)), sets[1],
        lambda task: learner.make_step(task, 2, 1),
        lambda ds: learner.train_task(ds, epochs=1), keys_of, want, "resume (grounding)")
    del learner, sets
    torch.cuda.empty_cache()


def cli_retrieval_phase(dk, fk, work):
    """Phase 12f: `train --synthetic --sessions 2 --epochs 1` at
    `RetrievalConfig()` (CLIP ViT-B/16 + LPI, 224 px, batch 64, bf16), no
    deform kernel launched; `eval --session 1` and `eval-all` equal to the
    training run's numbers; `report`; resume through a captured step."""
    from lpi_tpu_torch.config import RetrievalConfig
    from lpi_tpu_torch.continual.learner import RetrievalLearner
    from lpi_tpu_torch.continual.mid import fallback_sim_matrix
    from lpi_tpu_torch.core.checkpoint import SessionCheckpointer
    from lpi_tpu_torch.data.retrieval import synthetic_session
    from lpi_tpu_torch.data.tokenizer import ClipTokenizer

    cfg = RetrievalConfig()
    ck, res_dir = os.path.join(work, "ckpt_retrieval"), os.path.join(work, "res_retrieval")
    reset_counts(dk, fk)
    (path, learner), _, _ = run_cli("train", "--synthetic", "--sessions", "2", "--epochs", "1",
                                    "--output-dir", res_dir, "--checkpoint-dir", ck)
    launches = {k: v for k, v in launch_counts(dk, fk).items() if v}
    if launches:
        raise AssertionError(f"train launched deform kernels: {launches}")
    for session, steps, total in train_metrics(res_dir, cfg.batch_size):
        log(f"cli train session {session} on {card_line()}: {steps:.3f} steps/s (batch "
            f"{cfg.batch_size}; session 0's steps include the capture), total loss {total:.6f}")
    with open(path) as f:
        results = json.load(f)
    def keys_of(lr):
        return cpu_state({f"{side}.{f}": getattr(getattr(lr, f"{side}_keys"), f)
                          for side in ("visual", "textual") for f in ("centers", "valid")})

    want = {"pools": cpu_state(learner.pools), "keys": keys_of(learner)}
    del learner
    torch.cuda.empty_cache()

    res, _, _ = run_cli("eval", "--synthetic", "--checkpoint-dir", ck, "--session", "1",
                        "--config", reseeded(work))
    got = as_json({"mscoco": {"i2t": res["i2t"], "t2i": res["t2i"]}, "summary": res["summary"],
                   "task_id_accuracy": res["task_id_accuracy"]})
    if got != results["1"]:
        raise AssertionError(f"eval --session 1: {got}, trained {results['1']}")
    out, _, _ = run_cli("eval-all", "--synthetic", "--checkpoint-dir", ck,
                        "--config", reseeded(work))
    for s in (0, 1):
        rec = results[str(s)]
        if as_json(out[s]) != {"summary": rec["summary"],
                               "task_id_accuracy": rec["task_id_accuracy"]}:
            raise AssertionError(f"eval-all session {s}: {out[s]}, trained {rec}")
    log(f"cli eval --session 1 and eval-all: R@k, summaries and task-ID accuracies equal to "
        f"the training run's (session 1: r_mean {results['1']['summary']['r_mean']:.3f}, "
        f"task-ID {results['1']['task_id_accuracy']})")
    rep, _, _ = run_cli("report", path)
    log(f"cli report: {json.dumps(rep)}")

    learner = RetrievalLearner(cfg, task_sim_matrix=fallback_sim_matrix(cfg.total_sessions),
                               device="cuda")
    tok, size = ClipTokenizer(), cfg.clip.image_resolution
    sets = [synthetic_session(t, max(cfg.batch_size * 2, 16), size, tok, cfg.clip.n_ctx)
            for t in (0, 1)]
    resume_through_capture(
        learner, SessionCheckpointer(ck), next(sets[0].batches(cfg.batch_size)), sets[1],
        lambda task: learner.make_train_step(task, 2, 1),
        lambda ds: learner.train_session(ds, epochs=1), keys_of, want, "resume (retrieval)")
    del learner, sets
    torch.cuda.empty_cache()


def cli_phase(dk, fk, gen, records):
    """Phase 12: the batch-16 kernels, then the command line at full width
    in a temporary directory that is deleted afterwards, under
    deterministic algorithms."""
    import shutil
    import tempfile

    from lpi_tpu_torch.bench import deterministic

    t = time.perf_counter()
    p3 = {1: {CLI_P3: 1}, 2: {CLI_P3: 1}}
    for name, rec in check_window_shapes(dk, gen, records, CLI_BATCH, p3, "P3").items():
        records[name].update(b16_ms=rec["ms"], b16_bound_ms=rec["bound_ms"])
    log(f"phase 12a: {time.perf_counter() - t:.3f} s")
    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        with deterministic():
            t = time.perf_counter()
            cli_grounding_phase(dk, fk, records, work)
            log(f"phases 12b-12e, 12g: {time.perf_counter() - t:.3f} s")
            t = time.perf_counter()
            cli_retrieval_phase(dk, fk, work)
            log(f"phase 12f: {time.perf_counter() - t:.3f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---- phase 13: the baseline prompt types --------------------------------------
BASELINE_STEPS = 2


def cpu_depth_cut(cfg):
    """`cfg` with the head cut from 6 towers to 2, for every card-vs-CPU
    comparison of the grounding model (phases 4, 6 and 5b's, 13d, 14a, 14b,
    14d and 16c): the CPU's plain deformable convs take most of their time,
    and every width stays."""
    return with_head(cfg, num_convs=2)


def baseline_file(kind) -> str:
    """configs/baselines/{kind}.json of this checkout."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "baselines",
                        f"{kind}.json")


def baseline_config(kind, section, **overrides):
    """The default config's `section` ("retrieval" or "grounding") with
    `configs/baselines/{kind}.json` over it (zero-shot CLIP, which has no
    file: `prompt_type="clip"`), and `overrides`."""
    from lpi_tpu_torch.config import load_config

    if kind == "clip":
        return getattr(load_config(None, {section: {"lpi": {"prompt_type": "clip"},
                                                    **overrides}}), section)
    return getattr(load_config(baseline_file(kind), {section: overrides}), section)


def baseline_request(dk, fk, model, cfg, tok):
    """13c's request: one to a predictor of the trained `model` eagerly and
    one captured, after a first (`predict_phase`), with seeded task keys:
    equal task ids and detections, the forward's window launches."""
    from lpi_tpu_torch.continual.keys import TaskKeys

    rng = np.random.RandomState(13)
    feat_dim = cfg.dyhead.channels * 4 * 4  # P7 at 448 px
    centers = (rng.randn(cfg.total_tasks, cfg.num_key_clusters, feat_dim)
               / np.sqrt(feat_dim)).astype(np.float32)
    keys = TaskKeys(torch.from_numpy(centers), torch.ones(cfg.total_tasks, dtype=torch.bool))
    image = rng.randint(0, 256, size=(480, 640, 3)).astype(np.uint8)
    predict_phase(dk, fk, model, keys, tok, cfg, image, CLI_CAPTION, n_req=1, profile=False)


def cli_baseline_phase(dk, fk, work):
    """13e: `train-grounding --config configs/baselines/maple.json
    --synthetic --tasks 2 --epochs 1` at `GroundingConfig()` with MaPLe
    (448 px, bf16, batch 16, "pallas"): finite losses, the four window
    kernels launched; then `eval-all --grounding` from its checkpoints in a
    learner seeded 99: the head outputs of every eval batch, P@1/5/10 and
    the task-ID accuracy equal to the training run's in bits."""
    maple = baseline_file("maple")
    ck, res_dir = os.path.join(work, "ckpt_maple"), os.path.join(work, "res_maple")
    reset_counts(dk, fk)
    with grounding_head_outputs() as trained:
        (path, learner), _, _ = run_cli("train-grounding", "--config", maple, "--synthetic",
                                        "--tasks", "2", "--epochs", "1", "--output-dir",
                                        res_dir, "--checkpoint-dir", ck)
    launches = {k: v for k, v in launch_counts(dk, fk).items() if v}
    log(f"cli train-grounding (maple): launch counters {launches}; pools "
        f"{sorted(learner.pools)}")
    if set(launches) != set(CLI_WINDOW):
        raise AssertionError(f"train-grounding (maple) launched {launches}")
    if set(learner.pools) != {"prompts.textual", "prompts.proj_kernel", "prompts.proj_bias"}:
        raise AssertionError(f"train-grounding (maple) trained {sorted(learner.pools)}")
    batch = learner.cfg.batch_size
    del learner
    torch.cuda.empty_cache()
    for session, steps, total in train_metrics(res_dir, batch):
        log(f"cli train-grounding (maple) task {session} on {card_line()}: {steps:.3f} "
            f"steps/s (batch {batch}), total loss {total:.6f}")
    with open(path) as f:
        results = json.load(f)
    with open(maple) as f:
        section = json.load(f)["grounding"]
    seeded = os.path.join(work, "maple99.json")
    with open(seeded, "w") as f:
        json.dump({"grounding": {**section, "seed": 99}}, f)
    with grounding_head_outputs() as again:
        out, _, _ = run_cli("eval-all", "--grounding", "--synthetic", "--checkpoint-dir", ck,
                            "--config", seeded)
    if not trained or [d for d, _ in again] != [d for d, _ in trained]:
        raise AssertionError(f"eval-all --grounding (maple): the head outputs of its "
                             f"{len(again)} eval batches differ from the training run's")
    for s in (0, 1):
        got, rec = as_json(out[s]), results[str(s)]
        if (got["overall"], got["per_task"], got["task_id_accuracy"]) != (
                rec["overall"], rec["per_task"], rec["task_id_accuracy"]):
            raise AssertionError(f"eval-all --grounding (maple) task {s}: {got}, trained {rec}")
    log(f"cli eval-all --grounding (maple, a learner seeded 99): the head outputs of its "
        f"{len(again)} eval batches, P@1/5/10 and task-ID of both tasks equal the training "
        f"run's in bits")


def baseline_phase(dk, fk, tok):
    """Phase 13: the baseline prompt types at full width, seeded weights,
    under deterministic algorithms. 13a: the retrieval step with S-Prompts,
    L2P and zero-shot CLIP (`retrieval_train_phase`, 1 + 2 steps a mode);
    13b: their fp32 loss and pool gradient, card vs CPU, S-Prompts and L2P;
    13c: the grounding step ("pallas", batch 4, `honest_offsets`) with
    S-Prompts and with MaPLe (`train_phase`), then one request each,
    eager and captured; 13d: their fp32 loss and pool gradient at batch 1,
    card vs CPU (`gradient_phase`); 13e: the command line with MaPLe
    (`cli_baseline_phase`)."""
    import shutil
    import tempfile

    from lpi_tpu_torch.bench import deterministic

    with deterministic():
        for kind in ("sprompts", "l2p", "clip"):
            t = time.perf_counter()
            retrieval_train_phase(dk, fk, baseline_config(kind, "retrieval"), BASELINE_STEPS,
                                  f"retrieval {kind}", profile_eager=False)
            log(f"phase 13a ({kind}): {time.perf_counter() - t:.3f} s")
        for kind in ("sprompts", "l2p"):
            t = time.perf_counter()
            retrieval_gradient_phase(baseline_config(kind, "retrieval").lpi,
                                     f"retrieval {kind}")
            log(f"phase 13b ({kind}): {time.perf_counter() - t:.3f} s")
        for kind in ("sprompts", "maple"):
            t = time.perf_counter()
            cfg = baseline_config(kind, "grounding", batch_size=TRAIN_BATCH)
            batch, model = train_phase(dk, fk, cfg, tok, {}, f"pallas {kind}", keep_model=True,
                                       n_steps=BASELINE_STEPS, profile_eager=False)
            baseline_request(dk, fk, model, cfg, tok)
            del model
            torch.cuda.empty_cache()
            log(f"phase 13c ({kind}): {time.perf_counter() - t:.3f} s")
            t = time.perf_counter()
            log(f"phase 13d ({kind}): fp32 losses and pool gradient, card vs cpu, 2 towers")
            gradient_phase(cpu_depth_cut(cfg), batch)
            log(f"phase 13d ({kind}): {time.perf_counter() - t:.3f} s")
        work = tempfile.mkdtemp(prefix="chip_smoke_baselines_")
        try:
            t = time.perf_counter()
            cli_baseline_phase(dk, fk, work)
            log(f"phase 13e: {time.perf_counter() - t:.3f} s")
        finally:
            shutil.rmtree(work, ignore_errors=True)


# ---- phase 14: the head variants and GLIP-KNOW's detection mode ---------------
VARIANT_REQUESTS, VARIANT_STEPS = 3, 3
KNOWLEDGE = {
    "car": {"clean_name": "car", "def_wiki": "a road vehicle with four wheels.",
            "gpt3": ["cars have doors.", "cars drive on roads."]},
    "tree": {"clean_name": "tree", "def_wiki": "a tall perennial woody plant."},
    "dog": {"clean_name": "dog", "def_wiki": "a domesticated carnivorous mammal.",
            "gpt3": ["dogs bark."]},
}
CLASS_NAMES = ["car", "tree", "dog", "person", "bench"]


def seeded_keys(cfg, seed, p7=4):
    """Task keys: random unit-scale centres in the feature space of a P7 of
    side `p7` (4 at 448 px), every task valid."""
    from lpi_tpu_torch.continual.keys import TaskKeys

    rng = np.random.RandomState(seed)
    feat_dim = cfg.dyhead.channels * p7 * p7
    centers = (rng.randn(cfg.total_tasks, cfg.num_key_clusters, feat_dim)
               / np.sqrt(feat_dim)).astype(np.float32)
    return TaskKeys(torch.from_numpy(centers), torch.ones(cfg.total_tasks, dtype=torch.bool))


WARN_FRAC = 0.01  # check_deform_clipping's default warning threshold


def with_head(cfg, **dyhead):
    return dataclasses.replace(cfg, dyhead=dataclasses.replace(cfg.dyhead, **dyhead))


def no_kernel_request(dk, fk, model, cfg, keys, tok, image, caption, what):
    """14d: one bf16 request (eager) to `model`, whose head runs no deform
    kernel: every counter stays 0 and the reply is finite; then the fp32
    head outputs and task id, card against CPU."""
    from lpi_tpu_torch.serve.predictor import GroundingPredictor

    atss = dataclasses.replace(cfg.atss, inference_thresh=0.0)
    predictor = GroundingPredictor(model, keys, tok, image_size=cfg.image_size,
                                   score_thresh=0.0, atss_cfg=atss, device="cuda", eager=True)
    reset_counts(dk, fk)
    t = time.perf_counter()
    result = predictor.predict(image, caption)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    launches = {k: n for k, n in launch_counts(dk, fk).items() if n}
    if launches or not (len(result["boxes"]) > 0 and np.isfinite(result["scores"]).all()):
        raise AssertionError(f"{what}: launches {launches}, reply {result}")
    log(f"{what} request (eager, bf16) on {card_line()}: {ms:.3f} ms, no deform kernel "
        f"launched, {len(result['boxes'])} boxes, task_id {result['task_id']}")
    canvas, _ = predictor._prepare_image(image)
    ids, mask, _ = tok([caption])
    cfg32 = dataclasses.replace(cpu_depth_cut(cfg), dtype="float32")
    compare_heads(fp32_heads(model, cfg32, keys, canvas, ids, mask, "cuda"),
                  fp32_heads(model, cfg32, keys, canvas, ids, mask, "cpu"), f"{what}, card vs cpu")


def variants_phase(dk, fk, tok, records):
    """Phase 14, at `GroundingConfig()`'s full width with seeded weights:
    14a: the early-fusion request (GLIP-T(C)'s VLFuse, embed 2048 over 8
    heads, and a BERT layer before each of the 6 towers; 4,181 visual
    tokens against the padded text), eager and captured (`predict_phase`),
    then fp32 card against CPU; 14b: its train step (b4, task 1,
    `honest_offsets`, the fusion frozen, `train_phase`) and its fp32 loss
    and pool gradient, card vs CPU (`gradient_phase`); 14c: GLIP-KNOW's
    `predict_classes` on the LPI model with a knowledge json written here;
    14d: the plain head and the "exact" route, one request each, no deform
    kernel, fp32 card vs CPU; 14e: `check_deform_clipping` under its
    warning threshold at the seeded offsets and over it with the offset
    convs scaled, read at `honest_offsets` between, each the largest of
    the convs' recorded shares."""
    import shutil
    import tempfile

    from lpi_tpu_torch.bench import honest_offsets
    from lpi_tpu_torch.config import GroundingConfig
    from lpi_tpu_torch.data.knowledge import load_knowledge_file
    from lpi_tpu_torch.models.glip.grounding import GroundedVLModel, init_parameters
    from lpi_tpu_torch.serve.predictor import GroundingPredictor

    cfg = GroundingConfig(batch_size=TRAIN_BATCH)
    cfg_ef = with_head(cfg, early_fuse=True)
    keys = seeded_keys(cfg, 14)
    rng = np.random.RandomState(14)
    image = rng.randint(0, 256, size=(480, 640, 3)).astype(np.uint8)
    per_path = {}

    t = time.perf_counter()
    model = GroundedVLModel(cfg_ef)
    init_parameters(model, torch.Generator().manual_seed(0))
    log(f"14a: early fusion (embed {cfg_ef.dyhead.fuse_embed_dim}, "
        f"{cfg_ef.dyhead.fuse_heads} heads), {sum(p.numel() for p in model.head.fuses.parameters())}"
        f" VLFuse and {sum(p.numel() for p in model.head.langs.parameters())} BERT-layer "
        f"parameters in the head")
    predictor, launches, per_request = predict_phase(dk, fk, model, keys, tok, cfg_ef, image,
                                                     CLI_CAPTION, n_req=VARIANT_REQUESTS)
    per_path["early_fuse_request"] = (launches, per_request, VARIANT_REQUESTS)
    canvas, _ = predictor._prepare_image(image)
    ids, mask, _ = tok([CLI_CAPTION])
    del predictor
    cfg32 = dataclasses.replace(cpu_depth_cut(cfg_ef), dtype="float32")
    compare_heads(fp32_heads(model, cfg32, keys, canvas, ids, mask, "cuda"),
                  fp32_heads(model, cfg32, keys, canvas, ids, mask, "cpu"),
                  "early fusion (2 towers), card vs cpu")
    del model
    torch.cuda.empty_cache()
    log(f"phase 14a: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    step_records = {name: {} for name in records}
    batch = train_phase(dk, fk, cfg_ef, tok, step_records, "pallas early-fused",
                        n_steps=VARIANT_STEPS, profile_eager=False)
    per_path["early_fuse_step"] = (
        {k: v["launches"] for k, v in step_records.items() if v},
        {k: v["replay_launches_per_step"] for k, v in step_records.items() if v},
        VARIANT_STEPS)
    log("phase 14b: fp32 losses and pool gradient, early fusion, card vs cpu, 2 towers")
    gradient_phase(cpu_depth_cut(cfg_ef), batch)
    log(f"phase 14b: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    model = GroundedVLModel(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    work = tempfile.mkdtemp(prefix="chip_smoke_knowledge_")
    try:
        path = os.path.join(work, "knowledge.json")
        with open(path, "w") as f:
            json.dump(KNOWLEDGE, f)
        predictor, launches, per_request = predict_phase(
            dk, fk, model, None, tok, cfg, image, None, n_req=VARIANT_REQUESTS,
            classes=(CLASS_NAMES, load_knowledge_file(path)))
        per_path["knowledge_request"] = (launches, per_request, VARIANT_REQUESTS)
        del predictor
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"phase 14c: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    plain_cfg = with_head(cfg, use_dfconv=False, use_dyfuse=False, use_dyrelu=False)
    plain = GroundedVLModel(plain_cfg)
    init_parameters(plain, torch.Generator().manual_seed(0))
    no_kernel_request(dk, fk, plain, plain_cfg, keys, tok, image, CLI_CAPTION, "plain head")
    del plain
    exact_cfg = with_head(cfg, deform_impl="exact")
    exact = GroundedVLModel(exact_cfg)
    exact.load_state_dict(model.state_dict())
    no_kernel_request(dk, fk, exact, exact_cfg, keys, tok, image, CLI_CAPTION, "exact route")
    del exact
    torch.cuda.empty_cache()
    log(f"phase 14d: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    predictor = GroundingPredictor(model, keys, tok, image_size=cfg.image_size, device="cuda")
    readings = {}
    for offsets in ("seeded", "honest_offsets", "x100"):
        if offsets == "honest_offsets":
            honest_offsets(model)
        elif offsets == "x100":
            with torch.no_grad():
                for tower in model.head.towers:
                    tower.offset.weight.mul_(100.0)
        readings[offsets] = worst = predictor.check_deform_clipping(image)
        log(f"14e: check_deform_clipping at {offsets} offsets: {worst}")
    if not (readings["seeded"] < WARN_FRAC < readings["x100"]):
        raise AssertionError(f"check_deform_clipping: {readings}, warning at {WARN_FRAC}")
    del predictor, model
    torch.cuda.empty_cache()
    log(f"phase 14e: {time.perf_counter() - t:.3f} s")

    for path, (launches, per_call, calls) in per_path.items():
        for name, n in launches.items():
            if name in records and n:
                records[name].setdefault("phase14_launches", {})[path] = {
                    "host_calls": calls, "launches": n, "per_call_by_name": per_call[name]}


# ---- phase 15: the distributed steps (a process group, a mesh) --------------
MESH_RETRIEVAL_STEPS, MESH_GROUNDING_STEPS = 2, 2


def mesh_steps(dk, fk, learner, make_step, batch, steps, mode, before, what):
    """1 + `steps` steps of `make_step(eager)` from the pools `before`, in
    `mode` ("eager" or "captured"): the losses (finite), the pools after,
    the launch counters, the median step, peak memory and, captured, one
    profiled step."""
    with torch.no_grad():
        for name, p in learner.pools.items():
            p.copy_(before[name])
    step = make_step(mode == "eager")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(dk, fk)
    times, losses = [], []
    for i in range(1 + steps):
        if i == 1 and mode == "eager":
            reset_counts(dk, fk)
        t = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append({k: v.item() for k, v in metrics.items()})
        for k, v in losses[-1].items():
            if not np.isfinite(v):
                raise AssertionError(f"{what} step {i} ({mode}): {k} = {v}")
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts(dk, fk)
    med = statistics.median(times[1:])
    log(f"{what} ({mode}) on {card_line()}: median {med:.3f} ms over {steps} steps after the "
        f"first ({times[0]:.3f} ms); " + ", ".join(f"{k} {v:.6f}" for k, v in losses[-1].items()))
    pools = {n: p.detach().cpu().numpy() for n, p in learner.pools.items()}
    kernels = stats = None
    if mode == "captured":
        kernels, stats = _profile(lambda: step(batch), f"{what} step ({mode})")
    return dict(losses=losses, pools=pools, med=med, peak=peak, stats=stats,
                launches=launches, kernels=kernels)


def equal_bits(a, b, what):
    """Every step's metrics and every pool leaf of two runs equal in bits."""
    unequal = [f"step {i} {k}" for i, (x, y) in enumerate(zip(a["losses"], b["losses"]))
               for k in x if not np.float64(x[k]) == np.float64(y[k])]
    unequal += [n for n in a["pools"] if not np.array_equal(a["pools"][n], b["pools"][n])]
    if unequal:
        raise AssertionError(f"{what}: differ in bits at {unequal}")
    log(f"{what}: equal in bits, {len(a['losses'])} steps' metrics and {len(a['pools'])} "
        f"pool leaves")


def held_to(run, ref, what, rel=1e-4):
    """Each step's losses and each pool leaf of `run` against `ref` within
    relative Frobenius `rel` (the repo's bar; NCCL over several ranks
    promises no order of its sums)."""
    errs = {f"step {i} {k}": rel_frob(np.float64(a[k]), np.float64(b[k]))
            for i, (a, b) in enumerate(zip(run["losses"], ref["losses"])) for k in b}
    errs.update({n: rel_frob(run["pools"][n].astype(np.float64),
                             ref["pools"][n].astype(np.float64)) for n in ref["pools"]})
    worst = max(errs.items(), key=lambda kv: kv[1])
    log(f"{what}: largest relative Frobenius {worst[1]:.3e} at {worst[0]} (bar {rel}) over "
        f"{len(errs)} values")
    if not worst[1] <= rel:
        raise AssertionError(f"{what}: {worst[0]} off by {worst[1]:.3e}")


def mesh_table(runs, what, batch):
    """The medians of the runs side by side, with busy shares and peaks."""
    log(f"{what} on {card_line()}: " + "; ".join(
        f"{mode} median {r['med']:.3f} ms ({1e3 * batch / r['med']:.3f} samples/s), "
        f"{busy_share(r['stats'])}, peak {r['peak'] / 2**30:.3f} GiB"
        for mode, r in runs.items()))


def mesh_path(dk, fk, kind, mesh, ref=None):
    """15a ("retrieval": `RetrievalConfig()`, b64) or 15b ("grounding":
    `GroundingConfig()`, b4, "pallas", `honest_offsets`), full width, task
    1, under deterministic algorithms. One rank (`ref` None): a learner
    without a mesh and one on the mesh, each eager and captured, 1 + steps
    a mode from the same seeded start, all four equal in bits; the
    launches (none for retrieval; 54 / 24 / 54 / 24 a grounding step by
    the counters and, in a profiled replay, by kernel name). More ranks:
    the mesh's runs, eager and captured, each rank on its rows of the same
    global batch, held to `ref`, the one-process run. -> the one-process
    run, as numpy."""
    from lpi_tpu_torch.bench import deterministic, honest_offsets, retrieval_inputs
    from lpi_tpu_torch.config import GroundingConfig, RetrievalConfig
    from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
    from lpi_tpu_torch.continual.learner import RetrievalLearner
    from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
    from lpi_tpu_torch.data.grounding import synthetic_grounding_task
    from lpi_tpu_torch.graphs import WARMUP

    if kind == "retrieval":
        cfg, steps, phase, size = RetrievalConfig(), MESH_RETRIEVAL_STEPS, "15a", 64
        batch = retrieval_inputs(cfg)
    else:
        cfg, steps, phase, size = (GroundingConfig(batch_size=TRAIN_BATCH),
                                   MESH_GROUNDING_STEPS, "15b", TRAIN_BATCH)
        tok = BertTokenizer(max_len=cfg.bert.max_query_len, vocab_size=cfg.bert.vocab_size)
        batch = next(synthetic_grounding_task(TRAIN_TASK, TRAIN_BATCH, cfg.image_size, tok,
                                              max_boxes=cfg.max_boxes).batches(TRAIN_BATCH))

    def build(m):
        gen = torch.Generator().manual_seed(0)
        if kind == "retrieval":
            learner = RetrievalLearner(cfg, generator=gen, device=mesh.device, mesh=m)
            make = (lambda eager: learner.make_train_step(
                TRAIN_TASK, steps_per_epoch=100, epochs=cfg.epochs, eager=eager))
        else:
            learner = GroundingLearner(cfg, generator=gen, device=mesh.device, mesh=m)
            honest_offsets(learner.model)
            make = (lambda eager: learner.make_step(
                TRAIN_TASK, steps_per_epoch=steps, epochs=cfg.epochs_per_task, eager=eager))
        return learner, make, {n: p.detach().clone() for n, p in learner.pools.items()}

    if ref is None:
        plan = [("eager, no mesh", None, "eager"), ("captured, no mesh", None, "captured"),
                ("eager", mesh, "eager"), ("captured", mesh, "captured")]
    else:
        plan = [(f"{mesh.dp} ranks", mesh, "eager"),
                (f"{mesh.dp} ranks captured", mesh, "captured")]
    runs = {}
    with deterministic():
        for key, m, mode in plan:
            if mode == "eager":  # a captured run trains the eager run's learner again
                learner, make, before = build(m)
            run = mesh_steps(dk, fk, learner, make, batch, steps, mode, before,
                             f"{phase} {kind} {key}")
            calls = steps if mode == "eager" else WARMUP + 1
            want = (expected_counts(dk, fk, cfg, calls, train=True) if kind == "grounding"
                    else dict.fromkeys(run["launches"], 0))
            if run["launches"] != want:
                raise AssertionError(f"{phase} {key}: launches {run['launches']}, want {want} "
                                     f"over {calls} host calls")
            if kind == "grounding" and mode == "captured":
                check_replay_launches(dk, fk, cfg, run["kernels"], True,
                                      f"{phase} grounding {key}")
            runs[key] = run
    if ref is None:
        equal_bits(runs["eager, no mesh"], runs["eager"],
                   f"{phase} {kind}: mesh (1, 1) eager against no mesh eager")
        equal_bits(runs["eager"], runs["captured"],
                   f"{phase} {kind}: mesh (1, 1) captured against mesh eager")
        equal_bits(runs["captured, no mesh"], runs["captured"],
                   f"{phase} {kind}: mesh (1, 1) captured against no mesh captured")
    else:
        for key, run in runs.items():
            held_to(run, ref, f"{phase} {kind}: {key} against one process")
    mesh_table(runs, f"{phase} {kind} step (global batch {size})", size)
    out = runs[plan[0][0]]
    del learner, runs
    torch.cuda.empty_cache()
    return {"losses": out["losses"], "pools": out["pools"]}


def _mesh_rank(refs=None):
    """Phase 15 on each rank of an NCCL group, one rank a card: with one
    rank, 15a and 15b on a (1, 1) mesh (its collectives inside the steps);
    with more, 15c, held to `refs` (15a's and 15b's one-process runs). ->
    the one-process runs."""
    from lpi_tpu_torch.config import MeshConfig
    from lpi_tpu_torch.core import mesh as mesh_lib
    from lpi_tpu_torch.ops import deform_window_kernel as dk
    from lpi_tpu_torch.ops import fused_deform_kernel as fk

    mesh = mesh_lib.make_mesh(MeshConfig())
    log(f"phase 15: {mesh}, backend {torch.distributed.get_backend()}, the steps eager and "
        f"captured")
    out = {}
    for kind, phase in (("retrieval", "15a"), ("grounding", "15b")):
        t = time.perf_counter()
        out[kind] = mesh_path(dk, fk, kind, mesh, None if refs is None else refs[kind])
        log(f"phase {'15c' if refs else phase} ({kind}): {time.perf_counter() - t:.3f} s")
    return out


def mesh_phase():
    """Phase 15: the distributed steps in child processes (as the gates run),
    so that no process group touches the other phases: 15a and 15b on one
    rank (NCCL, the card), then 15c on two ranks when the machine has two
    cards."""
    from lpi_tpu_torch.dryrun import run_world

    refs = run_world(_mesh_rank, 1, "gpu", timeout=900)[0]
    cards = torch.cuda.device_count()
    if cards >= 2:
        run_world(_mesh_rank, 2, "gpu", (refs,), timeout=900)
    else:
        log(f"phase 15c did not run: it needs 2 cards, this machine has {cards} "
            f"({card_line()})")


# ---- phase 16: the dataset catalog, multi-scale training and TTA, the evaluators
# GLIP's AUGMENT.MULT_MIN_SIZE_TRAIN, the range `lpi_tpu/data/samplers.py` names
MULTI_SCALE = (480, 560, 640, 720, 800)
MULTI_SCALE_STEPS = 2
GROUPED_SIDES = (560, 800)
TTA_SCALES = (448, 560, 800)
TTA_CPU_SCALE = 560  # the scale whose fp32 head outputs are held card vs CPU
REFEXP_IMAGES = 32
REFEXP_CAPTION = "the toaster next to a red kettle"
# per category id of the fabricated ground truth: training images, the LVIS
# bins rare, common and frequent
LVIS_COUNTS = {1: 3, 2: 50, 3: 500}


def level_sides(px: int) -> list:
    """The head's five level sides at a `px` input (strides 8 to 128, each
    the ceiling of half the one before): 100, 50, 25, 13, 7 at 800 px."""
    sides = [-(-px // 8)]
    while len(sides) < 5:
        sides.append(-(-sides[-1] // 2))
    return sides


def write_refexp(root, n=REFEXP_IMAGES):
    """A fabricated mdetr RefExp set where the catalog looks for
    `refexp_train` under `root`: `n` JPEGs of about 640x480 (noise and one
    coloured box each), all of task 0 (appliance), under `coco/train2014`,
    and `mdetr_annotations/finetune_refcoco_train.json`. -> (the json's
    path, the image directory)."""
    from PIL import Image

    rng = np.random.RandomState(16)
    images = os.path.join(root, "coco", "train2014")
    os.makedirs(images)
    os.makedirs(os.path.join(root, "mdetr_annotations"))
    entries, anns = [], []
    for i in range(n):
        W, H = 640 - 8 * (i % 5), 480 + 6 * (i % 3)
        img = (rng.rand(H, W, 3) * 90).astype(np.uint8)
        w, h = rng.randint(W // 5, W // 2), rng.randint(H // 5, H // 2)
        x, y = rng.randint(0, W - w), rng.randint(0, H - h)
        img[y:y + h, x:x + w] = (220, 60 + 5 * i, 40)
        name = f"COCO_train2014_{i:012d}.jpg"
        Image.fromarray(img).save(os.path.join(images, name), quality=90)
        entries.append({"id": i, "file_name": name, "height": H, "width": W,
                        "caption": REFEXP_CAPTION})
        anns.append({"id": i + 1, "image_id": i, "category_id": 1,
                     "bbox": [float(x), float(y), float(w), float(h)],
                     "tokens_positive": [[4, 11]]})
    ann = os.path.join(root, "mdetr_annotations", "finetune_refcoco_train.json")
    with open(ann, "w") as f:
        json.dump({"images": entries, "annotations": anns, "categories": [
            {"id": 1, "name": "toaster", "supercategory": "appliance"}]}, f)
    return ann, images


def logged_losses(directory):
    """metrics.jsonl's records without their clocks."""
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        return [{k: v for k, v in json.loads(line).items()
                 if k not in ("time", "samples_per_sec")} for line in f]


def dataset_phase(dk, fk, work, ann, images):
    """16a: `train-grounding --dataset refexp_train --tasks 1 --epochs 1` at
    `GroundingConfig()` (b16, "pallas"), its files found through
    `$DATASET`, against the same command with `--ann/--image-root` on the
    same files: the results, the pools and metrics.jsonl's losses equal in
    bits, the four window kernels launched in each."""
    runs = {}
    saved = os.environ.get("DATASET")
    os.environ["DATASET"] = os.path.dirname(os.path.dirname(images))
    try:
        for how, source in (("dataset", ("--dataset", "refexp_train")),
                            ("ann", ("--ann", ann, "--image-root", images))):
            out = os.path.join(work, f"res_{how}")
            reset_counts(dk, fk)
            (path, learner), wall, _ = run_cli("train-grounding", *source, "--tasks", "1",
                                               "--epochs", "1", "--output-dir", out,
                                               "--checkpoint-dir", os.path.join(work, f"ck_{how}"))
            launches = {k: v for k, v in launch_counts(dk, fk).items() if v}
            log(f"16a train-grounding {' '.join(source[:2])}: {wall:.3f} s, launch counters "
                f"{launches}")
            if set(launches) != set(CLI_WINDOW):
                raise AssertionError(f"16a {how}: launched {launches}")
            with open(path) as f:
                runs[how] = (json.load(f), cpu_state(learner.pools), logged_losses(out))
            del learner
            torch.cuda.empty_cache()
    finally:
        if saved is None:
            os.environ.pop("DATASET")
        else:
            os.environ["DATASET"] = saved
    (res, pools, losses), (want_res, want_pools, want_losses) = runs["dataset"], runs["ann"]
    if res != want_res or losses != want_losses:
        raise AssertionError(f"16a: --dataset gave {res} {losses}, --ann {want_res} "
                             f"{want_losses}")
    same_state(pools, want_pools, "16a pools")
    if not all(np.isfinite(v) for rec in losses for v in rec.values()):
        raise AssertionError(f"16a: losses {losses}")
    log(f"16a: --dataset refexp_train equals --ann/--image-root in bits: results {res}, "
        f"{len(pools)} pool leaves, losses {losses}")


def check_level_kernels(dk, gen, records, px):
    """16b: rows 1f, 2f, 1b and 2b at every level shape of a `px` step
    (batch 4; `check_window_shapes`), summed over one step's launches into
    the records (`multi_scale`): per tower conv_same at every level and
    conv_up at all but the first at stride 1, conv_down from all but the
    last at stride 2, six towers."""
    sides = level_sides(px)
    shapes = {1: {s: (1 if i == 0 else 2) * TOWERS for i, s in enumerate(sides)},
              2: {s: TOWERS for s in sides[:-1]}}
    for name, rec in check_window_shapes(dk, gen, records, TRAIN_BATCH, shapes,
                                         f"{px} px").items():
        records[name].setdefault("multi_scale", {})[f"{px}px_per_step"] = rec
        log(f"kernel {name} per {px} px step on {card_line()}: {rec['ms']:.6f} ms against a "
            f"bound of {rec['bound_ms']:.6f} ms ({100 * rec['bound_ms'] / rec['ms']:.1f}%)")


def grouped_steps(dk, fk, cfg, batches):
    """16b, scale-grouped: a learner (seed 0, `honest_offsets`) runs the
    first batch at 560 and the first at 800 of `batches_grouped`, then each
    again, eagerly and captured from the same start under deterministic
    algorithms: each shape captured in its own graph and replayed, every
    metric and pool leaf equal in bits, the counters at the eager steps'
    launches and at the two captures' warm-ups."""
    from lpi_tpu_torch.bench import honest_offsets
    from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
    from lpi_tpu_torch.graphs import WARMUP

    learner = GroundingLearner(cfg, generator=torch.Generator().manual_seed(0), device="cuda")
    honest_offsets(learner.model)
    start = {n: p.detach().clone() for n, p in learner.pools.items()}
    order = [batches[s] for s in GROUPED_SIDES] * 2
    runs = {}
    for mode in ("eager", "captured"):
        with torch.no_grad():
            for n, p in learner.pools.items():
                p.copy_(start[n])
        step = learner.make_step(TRAIN_TASK, steps_per_epoch=len(order),
                                 epochs=cfg.epochs_per_task, eager=mode == "eager")
        reset_counts(dk, fk)
        losses, times = [], []
        for b in order:
            t = time.perf_counter()
            losses.append({k: v.item() for k, v in step(b).items()})
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        calls = len(order) if mode == "eager" else len(GROUPED_SIDES) * (WARMUP + 1)
        launches, want = launch_counts(dk, fk), expected_counts(dk, fk, cfg, calls, train=True)
        if launches != want:
            raise AssertionError(f"16b grouped ({mode}): launches {launches}, want {want}")
        log(f"16b grouped ({mode}) on {card_line()}: steps at {GROUPED_SIDES * 2} px "
            f"{[round(x, 3) for x in times]} ms, launch counters {launches} over {calls} host "
            f"calls; total losses {[round(x['total'], 6) for x in losses]}")
        runs[mode] = {"losses": losses, "pools": {n: p.detach().clone()
                                                  for n, p in learner.pools.items()}}
        del step
    sides = sorted(dict(k)["images"][1] for k in learner._graphs)
    if sides != sorted(GROUPED_SIDES):
        raise AssertionError(f"16b grouped: graphs at {sides}, want one at each of "
                             f"{GROUPED_SIDES}")
    same_bits(runs, "16b grouped (two shapes, each in its own graph)")
    del learner, runs
    torch.cuda.empty_cache()


def multiscale_train_phase(dk, fk, gen, tok, records, ann, images):
    """16b: multi-scale training at full width (b4, bf16, task 1,
    `honest_offsets`) on the fabricated RefExp set loaded with
    `AugmentConfig(multi_scale=MULTI_SCALE)`: a pad-to-max batch (800 px)
    through `train_phase` (1 + 2 steps a mode, 54 / 24 / 54 / 24, captured
    equal to eager in bits, median, samples/s, busy share, peak memory),
    the scale-grouped batches at 560 and 800 (`grouped_steps`), then the
    window kernels at the level shapes of 800 and 560 px
    (`check_level_kernels`)."""
    from lpi_tpu_torch.config import GroundingConfig
    from lpi_tpu_torch.data.grounding import load_mdetr_refexp
    from lpi_tpu_torch.data.samplers import padding_waste
    from lpi_tpu_torch.data.transforms import AugmentConfig

    cfg = GroundingConfig(batch_size=TRAIN_BATCH)
    aug = AugmentConfig(multi_scale=MULTI_SCALE)
    t = time.perf_counter()
    ds = load_mdetr_refexp(ann, images, 0, tok, max_boxes=cfg.max_boxes, augment=aug)
    padded = next(ds.batches(TRAIN_BATCH, seed=0))
    grouped = {}
    for b in ds.duplicated(3).batches_grouped(TRAIN_BATCH, seed=0):
        grouped.setdefault(b["images"].shape[1], b)
        if all(s in grouped for s in GROUPED_SIDES):
            break
    log(f"16b: {len(ds)} images stored at {aug.padded_size} px, pad-to-max batch "
        f"{padded['images'].shape}, grouped batches at {sorted(grouped)} px, "
        f"{time.perf_counter() - t:.3f} s; padding waste of pad-to-max over {MULTI_SCALE}: "
        f"{padding_waste(MULTI_SCALE, aug.padded_size):.4f}")
    if padded["images"].shape[1:3] != (800, 800) or not all(s in grouped for s in GROUPED_SIDES):
        raise AssertionError("16b: the multi-scale batches are not at their shapes")
    step_records = {name: {} for name in records}
    train_phase(dk, fk, cfg, tok, step_records, "pallas multi-scale 800 px",
                n_steps=MULTI_SCALE_STEPS, batch=padded, profile_eager=False)
    for name, rec in step_records.items():
        if rec:
            records[name].setdefault("multi_scale", {})["800px_step_launches"] = {
                "host_calls": MULTI_SCALE_STEPS, "launches": rec["launches"],
                "per_step_by_name": rec["replay_launches_per_step"]}
    grouped_steps(dk, fk, cfg, grouped)
    for px in (800, 560):
        check_level_kernels(dk, gen, records, px)


def tta_phase(dk, fk, tok, work):
    """16c: `eval.tta.multi_scale_detect` over `GroundingPredictor` requests
    at 448, 560 and 800 px with flips (six forwards; the callback builds one
    predictor per scale, with seeded task keys of that scale's P7), eagerly
    and captured: equal merged detections, the forwards' launches by the
    counters; then the fp32 head outputs at 560 px, card against CPU, at
    the repo's bar. -> the merged detections (host arrays)."""
    from lpi_tpu_torch.config import GroundingConfig
    from lpi_tpu_torch.eval.tta import multi_scale_detect
    from lpi_tpu_torch.graphs import WARMUP
    from lpi_tpu_torch.models.glip.grounding import GroundedVLModel, init_parameters
    from lpi_tpu_torch.serve.predictor import GroundingPredictor

    cfg = GroundingConfig(batch_size=TRAIN_BATCH)
    model = GroundedVLModel(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    keys = {s: seeded_keys(cfg, 16, level_sides(s)[-1]) for s in TTA_SCALES}
    image = np.random.RandomState(16).randint(0, 256, size=(480, 640, 3)).astype(np.uint8)
    atss = dataclasses.replace(cfg.atss, inference_thresh=0.0)
    merged, labels = {}, {}
    for mode in ("eager", "captured"):
        predictors = {s: GroundingPredictor(model, keys[s], tok, image_size=s, score_thresh=0.0,
                                            atss_cfg=atss, device="cuda",
                                            eager=mode == "eager") for s in TTA_SCALES}

        def predict_fn(img, scale, hflip):
            """Boxes in the resized image's coordinates, as the callback
            contract has them (the predictor maps them to the image's)."""
            H, W = img.shape[:2]
            out = predictors[scale].predict(np.ascontiguousarray(img), CLI_CAPTION)
            to_resized = np.asarray([scale / W, scale / H] * 2, np.float32)
            ids = [labels.setdefault(e, len(labels) + 1) for e in out["entities"]]
            return (out["boxes"] * to_resized, out["scores"], np.asarray(ids, np.int64),
                    (scale, scale))

        reset_counts(dk, fk)
        t = time.perf_counter()
        merged[mode] = multi_scale_detect(predict_fn, image, TTA_SCALES, flip=True)
        wall = (time.perf_counter() - t) * 1e3
        calls = 2 * len(TTA_SCALES) if mode == "eager" else len(TTA_SCALES) * (WARMUP + 1)
        launches = launch_counts(dk, fk)
        if launches != expected_counts(dk, fk, cfg, calls, train=False):
            raise AssertionError(f"16c TTA ({mode}): launches {launches} over {calls} forwards")
        t = time.perf_counter()
        again = multi_scale_detect(predict_fn, image, TTA_SCALES, flip=True)
        again_ms = (time.perf_counter() - t) * 1e3
        for k in merged[mode]:
            if not np.array_equal(again[k], merged[mode][k]):
                raise AssertionError(f"16c TTA ({mode}): a second request gave other {k}")
        out = merged[mode]
        if not (len(out["boxes"]) > 0 and np.isfinite(out["boxes"]).all()
                and np.isfinite(out["scores"]).all()):
            raise AssertionError(f"16c TTA ({mode}): {out}")
        log(f"16c TTA ({mode}) on {card_line()}: six forwards at {TTA_SCALES} px with flips, "
            f"first request {wall:.3f} ms, second {again_ms:.3f} ms; launch counters "
            f"{launches} over {calls} host calls of the forward; {len(out['boxes'])} merged "
            f"detections, labels {sorted(set(out['labels'].tolist()))}, top score "
            f"{float(out['scores'].max()):.4f}")
        if mode == "captured":
            canvas, _ = predictors[TTA_CPU_SCALE]._prepare_image(image)
        del predictors
    for k in merged["eager"]:
        if not np.array_equal(merged["eager"][k], merged["captured"][k]):
            raise AssertionError(f"16c TTA: captured and eager merged {k} differ")
    log(f"16c TTA: captured and eager give the same {len(merged['eager']['boxes'])} merged "
        f"detections")
    ids, mask, _ = tok([CLI_CAPTION])
    cfg32 = dataclasses.replace(cpu_depth_cut(cfg), dtype="float32")
    compare_heads(fp32_heads(model, cfg32, keys[TTA_CPU_SCALE], canvas, ids, mask, "cuda"),
                  fp32_heads(model, cfg32, keys[TTA_CPU_SCALE], canvas, ids, mask, "cpu"),
                  f"{TTA_CPU_SCALE} px, card vs cpu")
    del model
    torch.cuda.empty_cache()
    return merged["captured"]


def eval_detection_phase(work, merged):
    """16d: `eval-detection` with the COCO, LVIS, VOC and Flickr protocols,
    in this process, on 16c's merged detections written as a predictions
    json, against a fabricated ground truth (per category, its best
    detection moved by 3 px, or a box of its own where it has none; one
    category in each LVIS bin; one box `difficult`): every value finite and
    equal to the port's evaluator called directly."""
    from lpi_tpu_torch.eval.coco_ap import evaluate_detections
    from lpi_tpu_torch.eval.flickr import FlickrEvaluator
    from lpi_tpu_torch.eval.lvis import LvisEvaluator
    from lpi_tpu_torch.eval.voc import eval_detection_voc

    boxes = merged["boxes"].astype(np.float64)
    scores, labels = merged["scores"].astype(np.float64), merged["labels"].astype(np.int64)
    gt_boxes = []
    for c in LVIS_COUNTS:
        mine = np.flatnonzero(labels == c)
        box = boxes[mine[np.argmax(scores[mine])]] + 3.0 if len(mine) else \
            np.asarray([40.0 * c, 30.0, 40.0 * c + 120.0, 200.0])
        gt_boxes.append(box)
    gt_boxes.append(np.asarray([300.0, 200.0, 420.0, 330.0]))
    gt_labels = [*LVIS_COUNTS, 1]
    difficult = [0, 0, 0, 1]
    gt = {"images": [{"id": 0, "neg_category_ids": [5], "not_exhaustive_category_ids": []}],
          "categories": [{"id": c, "image_count": n} for c, n in LVIS_COUNTS.items()],
          "annotations": [{"id": i + 1, "image_id": 0, "category_id": int(l),
                           "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0]),
                                    float(b[3] - b[1])], "difficult": d}
                          for i, (b, l, d) in enumerate(zip(gt_boxes, gt_labels, difficult))]}
    preds = [{"image_id": 0, "boxes": boxes.tolist(), "scores": scores.tolist(),
              "labels": labels.tolist()}]
    phrases = [{"boxes": boxes[labels == c].tolist(), "scores": scores[labels == c].tolist(),
                "gt_boxes": [gt_boxes[i].tolist()], "phrase_types": ["objects"]}
               for i, c in enumerate(LVIS_COUNTS)]
    paths = {}
    for name, obj in (("gt", gt), ("preds", preds), ("phrases", phrases)):
        paths[name] = os.path.join(work, f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(obj, f)
    # the ground truth as the command reads it (xywh back to xyxy)
    gt_xyxy = [[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                a["bbox"][1] + a["bbox"][3]] for a in gt["annotations"]]
    det = {"boxes": preds[0]["boxes"], "scores": preds[0]["scores"],
           "labels": preds[0]["labels"]}
    direct = {}
    res = evaluate_detections([det], [{"boxes": gt_xyxy, "labels": gt_labels}])
    res.pop("per_class")
    direct["coco"] = res
    ev = LvisEvaluator(category_image_counts=LVIS_COUNTS)
    ev.update(det["boxes"], det["scores"], det["labels"], gt_xyxy, gt_labels, pos_cats=[],
              neg_cats=[5])
    direct["lvis"] = ev.summarize()
    direct["lvis"].pop("per_class")
    out = eval_detection_voc([{"boxes": gt_xyxy, "labels": gt_labels, "difficult": difficult}],
                             [det])
    direct["voc"] = {"map": out["map"], "ap": {i: float(v) for i, v in enumerate(out["ap"])
                                               if v == v}}
    ev = FlickrEvaluator()
    for p in phrases:
        ev.update(p["boxes"], p["scores"], p["gt_boxes"], phrase_types=p["phrase_types"])
    direct["flickr"] = ev.summarize()
    for protocol in ("coco", "lvis", "voc", "flickr"):
        source = paths["phrases" if protocol == "flickr" else "preds"]
        got, wall, _ = run_cli("eval-detection", source, "--gt", paths["gt"], "--protocol",
                               protocol)
        values = [v for k, v in got.items() if k != "ap"] + list(got.get("ap", {}).values())
        if got != direct[protocol] or not all(np.isfinite(v) for v in values):
            raise AssertionError(f"16d eval-detection {protocol}: {got}, the evaluator "
                                 f"directly {direct[protocol]}")
        log(f"16d eval-detection --protocol {protocol}: {wall:.3f} s, {as_json(got)}, equal to "
            f"the evaluator called directly, every value finite")


def multiscale_phase(dk, fk, gen=None, tok=None, records=None):
    """Phase 16, under deterministic algorithms, in a temporary directory
    deleted afterwards: 16a `train-grounding --dataset`, 16b multi-scale
    training and the window kernels at its level shapes, 16c multi-scale
    TTA, 16d `eval-detection`. Called alone, it makes its own generator,
    tokenizer and kernel records."""
    import shutil
    import tempfile

    from lpi_tpu_torch.bench import deterministic
    from lpi_tpu_torch.config import BertConfig
    from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer

    gen = gen or torch.Generator(device="cuda").manual_seed(0)
    tok = tok or BertTokenizer(max_len=BertConfig().max_query_len,
                               vocab_size=BertConfig().vocab_size)
    if records is None:
        records = {fn.__name__: _record(fn.__name__, "") for fn in (*dk.KERNELS, *fk.KERNELS)}

    work = tempfile.mkdtemp(prefix="chip_smoke_datasets_")
    try:
        with deterministic():
            ann, images = write_refexp(os.path.join(work, "DATASET"))
            t = time.perf_counter()
            dataset_phase(dk, fk, work, ann, images)
            log(f"phase 16a: {time.perf_counter() - t:.3f} s")
            t = time.perf_counter()
            multiscale_train_phase(dk, fk, gen, tok, records, ann, images)
            log(f"phase 16b: {time.perf_counter() - t:.3f} s")
            t = time.perf_counter()
            merged = tta_phase(dk, fk, tok, work)
            log(f"phase 16c: {time.perf_counter() - t:.3f} s")
            t = time.perf_counter()
            eval_detection_phase(work, merged)
            log(f"phase 16d: {time.perf_counter() - t:.3f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---- phase 17: the detector zoo ---------------------------------------------
ZOO_CLASSES = 80
ZOO_IMAGE = (800, 1216)
ZOO_STRIDES = (8, 16, 32, 64, 128)
ZOO_GT = 20  # GT slots an image, some padded
ZOO_REPS = 5  # eager steps timed a head (after one warm-up)
SWIN_LEVELS = [(200, 304, 96), (100, 152, 192), (50, 76, 384), (25, 38, 768)]


def level_shapes(h: int, w: int, strides) -> list:
    """Sides of the maps at `strides` of an h x w image, as the zoo's
    stride-2 'SAME' convs give them (each level the ceiling of half the
    last)."""
    out, (H, W), s = [], (h, w), 1
    for stride in strides:
        while s < stride:
            H, W, s = -(-H // 2), -(-W // 2), s * 2
        out.append((H, W))
    return out


def zoo_backbones():
    """17a's backbones: (name, constructor taking a dtype, image side, whether it
    takes text, [(H, W, C)] of its levels at that side)."""
    from lpi_tpu_torch.models.glip.efficientnet import EfficientNetBiFPN
    from lpi_tpu_torch.models.glip.fbnet import FBNet
    from lpi_tpu_torch.models.glip.resnet import ResNet
    from lpi_tpu_torch.models.glip.swin import SwinTransformer
    from lpi_tpu_torch.models.glip.swin_variants import SwinTransformerV2, SwinTransformerVL

    swin = dict(out_stages=(2, 3, 4, 5))  # Swin-T: 96, (2, 2, 6, 2), (3, 6, 12, 24), window 7
    return (
        ("ResNet-50", lambda dt: ResNet((3, 4, 6, 3), 64, dt), ZOO_IMAGE, False,
         [(100, 152, 512), (50, 76, 1024), (25, 38, 2048)]),
        ("Swin-T", lambda dt: SwinTransformer(**swin, dtype=dt), ZOO_IMAGE, False, SWIN_LEVELS),
        ("Swin-T v2", lambda dt: SwinTransformerV2(**swin, dtype=dt), ZOO_IMAGE, False,
         SWIN_LEVELS),
        ("Swin-T VL", lambda dt: SwinTransformerVL(**swin, dtype=dt), ZOO_IMAGE, True,
         SWIN_LEVELS),
        ("EfficientNet-B0 + BiFPN", lambda dt: EfficientNetBiFPN(64, 3, dtype=dt), (512, 512),
         False, [(64, 64, 64), (32, 32, 64), (16, 16, 64), (8, 8, 64), (4, 4, 64)]),
        ("FBNet-C", lambda dt: FBNet(dtype=dt), ZOO_IMAGE, False,
         [(100, 152, 32), (50, 76, 112), (25, 38, 352)]),
    )


def zoo_inputs(side, batch: int, text: bool, tokens: int, device):
    """Seeded images [B, H, W, 3] and, for the VL tower, a 768-wide text
    hidden of `tokens` with the last tokens of each row padded."""
    g = torch.Generator().manual_seed(side[0] * 7 + side[1] + tokens)
    out = [torch.randn(batch, *side, 3, generator=g)]
    if text:
        mask = torch.ones(batch, tokens)
        for b in range(batch):
            mask[b, tokens - 5 * (b + 1):] = 0
        out += [torch.randn(batch, tokens, 768, generator=g), mask]
    return [x.to(device) for x in out]


def zoo_levels(out) -> list:
    """A backbone's output as a flat list of tensors (the VL tower's text
    hidden last)."""
    if isinstance(out, tuple):
        return list(out[0]) + [out[1]]
    return list(out)


def finite(tensors, what) -> None:
    for i, x in enumerate(tensors):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{what}: output {i} not finite")


def equal_bits_all(a, b, what) -> None:
    for i, (x, y) in enumerate(zip(a, b)):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: two fp32 calls differ in bits at output {i}")


def median_eager_ms(fn, reps: int = ZOO_REPS) -> float:
    """Host clock around `reps` eager calls (each synchronized), after one
    warm-up; the median, ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def held_card_cpu(card_outs, cpu_outs, what, worst, slot=0) -> None:
    """Card against the CPU at the repo's bar, the largest relative error
    kept in `worst[slot]` (0 fp32, 2 fp64); a disagreement is logged and
    kept in `worst[1]`, which the phase raises on at its end."""
    for i, (a, b) in enumerate(zip(card_outs, cpu_outs)):
        a, b = a.detach().double().cpu().numpy(), b.detach().double().numpy()
        try:
            assert_close(a, b, f"{what} [{i}] {tuple(b.shape)}", where="17d card vs cpu",
                         dtype="fp64" if slot == 2 else "fp32")
        except AssertionError as e:
            worst[1].append(str(e))
        worst[slot] = max(worst[slot], rel_frob(a, b))


def backbone_part(name, build, side, text, want, worst) -> None:
    """17a for one backbone (b2, bf16 and fp32 at full width: shapes,
    finite, graph-replay median, peak memory; the fp32 call twice, equal
    bits), then 17d (fp32 card vs CPU at a small side)."""
    import copy

    from lpi_tpu_torch.continual.keys import exact_fp32
    from lpi_tpu_torch.models.glip.resnet import init_parameters

    cpu32 = build(torch.float32).eval()
    init_parameters(cpu32, torch.Generator().manual_seed(17))
    n_params = sum(p.numel() for p in cpu32.parameters())
    inputs = zoo_inputs(side, 2, text, 256, "cuda")
    for dt in (torch.bfloat16, torch.float32):
        m = build(dt).eval()
        m.load_state_dict(cpu32.state_dict())
        m = m.cuda()
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            outs = zoo_levels(m(*inputs))
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() / 2**30
            got = [tuple(o.shape[1:]) for o in outs[:len(want)]]
            if got != [tuple(w) for w in want] or any(o.shape[0] != 2 for o in outs):
                raise AssertionError(f"17a {name} {dt}: levels {got}, want {want}")
            if text and tuple(outs[-1].shape) != (2, 256, 768):
                raise AssertionError(f"17a {name}: text hidden {tuple(outs[-1].shape)}")
            finite(outs, f"17a {name} {dt}")
            if dt == torch.float32:
                equal_bits_all(outs, zoo_levels(m(*inputs)), f"17a {name}")
            ms = device_time_ms(lambda: m(*inputs), reps=20)
        log(f"17a {name} ({n_params:,} parameters) {str(dt)[6:]} b2 at {side[0]}x{side[1]} "
            f"on {card_line()}: forward {ms:.3f} ms (median of 20 graph replays), peak "
            f"{peak:.3f} GiB, levels {got}{', text (2, 256, 768)' if text else ''}, finite"
            + (", two fp32 calls equal in bits" if dt == torch.float32 else ""))
        del m, outs
        torch.cuda.empty_cache()

    small = (96, 96) if side == (512, 512) else (64, 96)
    x_cpu = zoo_inputs(small, 1, text, 32, "cpu")
    card = copy.deepcopy(cpu32).cuda()
    t = time.perf_counter()
    with torch.no_grad(), exact_fp32():
        ours = zoo_levels(card(*[x.cuda() for x in x_cpu]))
        theirs = zoo_levels(cpu32(*x_cpu))
    held_card_cpu(ours, theirs, f"17d {name} at {small[0]}x{small[1]}", worst)
    log(f"17d {name}: {time.perf_counter() - t:.3f} s")
    del card


def zoo_features(shapes, channels, batch, device, seed, grad=False):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(batch, h, w, channels, generator=g).to(device).requires_grad_(grad)
            for h, w in shapes]


def zoo_ground_truth(h, w, batch, device, seed, n_valid=(14, 9)):
    """[B, ZOO_GT] padded GT boxes (sides 4-50% of the image), 1-based
    labels of 80 classes, validity."""
    rng = np.random.RandomState(seed)
    boxes = np.zeros((batch, ZOO_GT, 4), np.float32)
    labels = np.zeros((batch, ZOO_GT), np.int64)
    valid = np.zeros((batch, ZOO_GT), bool)
    for b in range(batch):
        n = n_valid[b]
        wh = rng.uniform(0.04, 0.5, (n, 2)) * (w, h)
        xy = rng.uniform(0, 1, (n, 2)) * ((w, h) - wh)
        boxes[b, :n] = np.concatenate([xy, xy + wh], 1)
        labels[b, :n] = rng.randint(1, ZOO_CLASSES + 1, n)
        valid[b, :n] = True
    return [torch.from_numpy(a).to(device) for a in (boxes, labels, valid)]


def retina_anchors(shapes):
    """9 anchors a location (3 octave scales x ratios 0.5, 1, 2), sizes
    32-512, from `anchors.grid_anchors` (concat_anchors' per-level grids),
    location-major as the head's A x C channels are."""
    from lpi_tpu_torch.models.glip.anchors import grid_anchors

    sizes = np.array([32, 64, 128, 256, 512], np.float32)
    per_scale = [grid_anchors(shapes, ZOO_STRIDES, sizes * 2 ** (i / 3), (0.5, 1.0, 2.0))
                 for i in range(3)]
    levels = [np.stack([per_scale[i][lv].reshape(-1, 3, 4) for i in range(3)], 1).reshape(-1, 4)
              for lv in range(len(shapes))]
    return np.concatenate(levels)


def head_losses(shapes, device):
    """17b's loss functions over the levels `shapes`: {name: loss(head,
    feats, gt) -> dict}."""
    from lpi_tpu_torch.models.glip.anchors import concat_anchors
    from lpi_tpu_torch.models.glip.atss_head import atss_class_losses
    from lpi_tpu_torch.models.glip.fcos import DEFAULT_RANGES, fcos_locations, fcos_losses
    from lpi_tpu_torch.models.glip.retina import retina_losses

    locs = fcos_locations(shapes, ZOO_STRIDES)
    points = torch.from_numpy(np.concatenate(locs)).to(device)
    ranges = torch.from_numpy(np.concatenate(
        [np.tile(np.asarray(r, np.float32), (len(l), 1)) for l, r in zip(locs, DEFAULT_RANGES)]
    )).to(device)
    r_anchors = torch.from_numpy(retina_anchors(shapes)).to(device)
    a_anchors, counts = concat_anchors(shapes, ZOO_STRIDES, [64, 128, 256, 512, 1024])
    a_anchors = torch.from_numpy(a_anchors).to(device)

    def cat(levels, last):
        return torch.cat([x.reshape(x.shape[0], -1, last) for x in levels], 1)

    def fcos(head, feats, gt):
        out = head(feats)
        return fcos_losses(points, ranges, cat(out["cls_logits"], ZOO_CLASSES),
                           cat(out["ltrb"], 4), cat(out["centerness"], 1)[..., 0], *gt)

    def retina(head, feats, gt):
        out = head(feats)
        return retina_losses(r_anchors, cat(out["cls_logits"], ZOO_CLASSES),
                             cat(out["bbox_pred"], 4), *gt)

    def atss(head, feats, gt):
        out = head(feats)
        return atss_class_losses(a_anchors, counts, cat(out["cls_logits"], ZOO_CLASSES),
                                 cat(out["bbox_pred"], 4), cat(out["centerness"], 1)[..., 0],
                                 *gt)

    return dict(zip(DENSE_HEADS, (fcos, retina, atss)))


DENSE_HEADS = ("FCOS (256, 4 convs)", "RetinaNet (256, 4 convs, 9 anchors)",
               "ATSS (128, 2 convs)")


def dense_heads():
    """17b's heads at published widths, seeded on the CPU."""
    from lpi_tpu_torch.models.glip.atss_head import ATSSDetHead
    from lpi_tpu_torch.models.glip.fcos import FCOSHead
    from lpi_tpu_torch.models.glip.resnet import init_parameters
    from lpi_tpu_torch.models.glip.retina import RetinaNetHead

    heads = (FCOSHead(ZOO_CLASSES), RetinaNetHead(ZOO_CLASSES), ATSSDetHead(ZOO_CLASSES))
    for i, head in enumerate(heads):
        init_parameters(head, torch.Generator().manual_seed(170 + i))
    return dict(zip(DENSE_HEADS, heads))


def loss_total(losses) -> torch.Tensor:
    return sum(v for k, v in losses.items() if k.startswith("loss"))


def step_grads(module, loss_fn, *args):
    """One forward, loss and backward into the module's parameters ->
    (losses as floats, [grads], the forward's floating outputs' losses)."""
    module.zero_grad(set_to_none=True)
    losses = loss_fn(module, *args)
    loss_total(losses).backward()
    return losses, [p.grad for p in module.parameters()]


def in_dtype(module, dtype):
    """`module` with its parameters and every layer's compute type (Flax's
    `dtype=`, which a layer built with one keeps) set to `dtype`."""
    module = module.to(dtype=dtype)
    for m in module.modules():
        for attr in ("compute_dtype", "dtype"):
            if isinstance(getattr(m, attr, None), torch.dtype):
                setattr(m, attr, dtype)
    return module


def card_cpu_step(what, run, worst) -> None:
    """17d for one step. `run(device, dtype)` -> (losses, [gradients]) from
    the same seeded weights and inputs. The losses in fp32, card (TF32 off)
    against the CPU; the losses and the concatenated gradient in fp64, card
    against the CPU. In fp32 the gradients of these conv stacks are not
    fixed to 1e-4 by the code alone: cuDNN's fp32 backward algorithms (TF32
    off) and the CPU's reductions each land up to a few 1e-3 from the fp64
    gradient in some layers, so fp32's gradient error against the CPU's
    fp64 is printed for both and held to nothing."""
    from lpi_tpu_torch.continual.keys import exact_fp32

    def flat(grads):
        return torch.cat([g.detach().double().cpu().reshape(-1) for g in grads])

    def loss_list(losses):
        return [v.detach().reshape(1) for k, v in losses.items() if k.startswith("loss")]

    with exact_fp32():
        k32 = run("cuda", torch.float32)
        k64 = run("cuda", torch.float64)
    c32, c64 = run("cpu", torch.float32), run("cpu", torch.float64)
    held_card_cpu(loss_list(k32[0]), loss_list(c32[0]), f"{what} losses", worst)
    held_card_cpu(loss_list(k64[0]) + [flat(k64[1])], loss_list(c64[0]) + [flat(c64[1])],
                  f"{what} losses and parameter gradient", worst, slot=2)
    ref = flat(c64[1]).numpy()
    log(f"{what}: fp32 gradient against the CPU's fp64, card (TF32 off) "
        f"{rel_frob(flat(k32[1]).numpy(), ref):.3e}, "
        f"CPU {rel_frob(flat(c32[1]).numpy(), ref):.3e}")


def dense_head_part(worst) -> None:
    """17b: FCOS, RetinaNet and ATSS over P3-P7 of an 800 x 1216 image, b2,
    20 GT slots an image: forward, losses, backward into the head; finite;
    the fp32 forward twice, equal bits; median step. 17d: the same heads
    card vs CPU on the levels of a 128 x 192 image (`card_cpu_step`)."""
    import copy

    shapes = level_shapes(*ZOO_IMAGE, ZOO_STRIDES)
    feats = zoo_features(shapes, 256, 2, "cuda", 171)
    gt = zoo_ground_truth(*ZOO_IMAGE, 2, "cuda", 172)
    small = level_shapes(128, 192, ZOO_STRIDES)
    feats_cpu = zoo_features(small, 256, 2, "cpu", 173)
    gt_cpu = zoo_ground_truth(128, 192, 2, "cpu", 174, (5, 3))
    losses_full = head_losses(shapes, "cuda")
    losses_cpu, losses_card = head_losses(small, "cpu"), head_losses(small, "cuda")
    for name, cpu_head in dense_heads().items():
        loss_fn = losses_full[name]
        head = copy.deepcopy(cpu_head).cuda()
        torch.cuda.reset_peak_memory_stats()
        losses, grads = step_grads(head, loss_fn, feats, gt)
        finite([v.reshape(1) for k, v in losses.items() if k.startswith("loss")] + grads,
               f"17b {name}")
        with torch.no_grad():
            a, b = head(feats), head(feats)
            equal_bits_all([x for k in a for x in a[k]], [x for k in b for x in b[k]],
                           f"17b {name}")
        ms = median_eager_ms(lambda: step_grads(head, loss_fn, feats, gt))
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"17b {name} b2 at P3-P7 of {ZOO_IMAGE[0]}x{ZOO_IMAGE[1]} on {card_line()}: "
            f"step (forward, losses, backward) {ms:.3f} ms eager (median of {ZOO_REPS}), peak "
            f"{peak:.3f} GiB; losses {', '.join(f'{k} {v.item():.4f}' for k, v in losses.items())}"
            f"; finite; two fp32 forwards equal in bits")
        t = time.perf_counter()

        def run(dev, dtype, cpu_head=cpu_head, name=name):
            h = in_dtype(copy.deepcopy(cpu_head), dtype).to(dev)
            boxes, labels, valid = (g.to(dev) for g in gt_cpu)
            return step_grads(h, (losses_card if dev == "cuda" else losses_cpu)[name],
                              [f.to(device=dev, dtype=dtype) for f in feats_cpu],
                              [boxes.to(dtype), labels, valid])

        card_cpu_step(f"17d {name}", run, worst)
        log(f"17d {name}: {time.perf_counter() - t:.3f} s")
        del head
        torch.cuda.empty_cache()


def zoo_rois(n_per_image, h, w, batch, device, seed, lo=16.0, hi=0.6):
    """[batch * n, 5] ROIs (batch index, x1, y1, x2, y2), sides from `lo` px
    to `hi` of the image, some across the border."""
    rng = np.random.RandomState(seed)
    n = n_per_image * batch
    wh = np.exp(rng.uniform(np.log(lo), np.log(hi * min(h, w)), (n, 2)))
    xy = rng.uniform(-0.05, 1.0, (n, 2)) * (w, h) - wh / 2
    b = np.repeat(np.arange(batch), n_per_image)[:, None]
    return torch.from_numpy(np.concatenate([b, xy, xy + wh], 1).astype(np.float32)).to(device)


def roi_modules():
    """17c's heads, seeded on the CPU."""
    from lpi_tpu_torch.models.glip.resnet import init_parameters
    from lpi_tpu_torch.models.glip.roi_heads import BoxHead
    from lpi_tpu_torch.models.glip.roi_mask_keypoint import KeypointHead, MaskHead

    mods = {"box": BoxHead(ZOO_CLASSES, in_features=7 * 7 * 256),
            "mask": MaskHead(ZOO_CLASSES), "keypoint": KeypointHead(17, in_channels=256)}
    for i, m in enumerate(mods.values()):
        init_parameters(m, torch.Generator().manual_seed(180 + i))
    return mods


def roi_steps(mods, feats, rois, psmap, ps_rois, trans, seed):
    """The ROI path's four steps as closures on the given inputs ->
    {name: (module or None, step() -> (losses, forward outputs))}."""
    from lpi_tpu_torch.models.glip.roi_heads import multilevel_roi_align, roi_box_loss
    from lpi_tpu_torch.models.glip.roi_mask_keypoint import keypoint_loss, mask_loss
    from lpi_tpu_torch.ops.deform_pool import deform_psroi_pool

    dev = rois.device
    g = torch.Generator().manual_seed(seed)
    R = rois.shape[0]
    labels = torch.randint(0, ZOO_CLASSES + 1, (R,), generator=g).to(dev)
    valid = (torch.rand(R, generator=g) > 0.1).to(dev)
    matched = rois[:, 1:] + (torch.randn(R, 4, generator=g) * 4).to(dev)
    n_mask, n_kp = max(R // 8, 1), max(R // 16, 1)
    masks = (torch.rand(n_mask, 28, 28, generator=g) > 0.5).float().to(dev)
    mask_labels = torch.randint(0, ZOO_CLASSES, (n_mask,), generator=g).to(dev)
    kp_boxes = rois[:n_kp, 1:]
    kps = torch.cat([kp_boxes[:, None, :2] + torch.rand(n_kp, 17, 2, generator=g).to(dev)
                     * (kp_boxes[:, None, 2:] - kp_boxes[:, None, :2]),
                     torch.randint(0, 3, (n_kp, 17, 1), generator=g).float().to(dev)], -1)
    ct = torch.randn(ps_rois.shape[0], 7, 7, 8, generator=g).to(dev)
    strides = (4, 8, 16, 32)

    def box():
        cls, deltas = mods["box"](multilevel_roi_align(feats, rois, strides, 7))
        return roi_box_loss(cls, deltas, rois[:, 1:], labels, matched, valid), [cls, deltas]

    def mask():
        logits = mods["mask"](multilevel_roi_align(feats, rois[:n_mask], strides, 14))
        return {"loss_mask": mask_loss(logits, masks, mask_labels, torch.ones_like(
            mask_labels, dtype=torch.bool))}, [logits]

    def keypoint():
        maps = mods["keypoint"](multilevel_roi_align(feats, rois[:n_kp], strides, 14))
        return {"loss_keypoint": keypoint_loss(maps, kps, kp_boxes, torch.ones(
            n_kp, dtype=torch.bool, device=dev))}, [maps]

    def psroi():
        out = deform_psroi_pool(psmap, ps_rois, trans, out_size=7, out_dim=8,
                                spatial_scale=1 / 16, group_size=7)
        return {"loss_psroi": (out * ct).sum()}, [out]

    return {"BoxHead + multilevel_roi_align + roi_box_loss": ("box", box),
            "MaskHead (14 -> 28) + mask_loss": ("mask", mask),
            "KeypointHead (17 keypoints, 56 px) + keypoint_loss": ("keypoint", keypoint),
            "deform_psroi_pool (group 7, out 7, out_dim 8, offsets)": (None, psroi)}


def roi_inputs(h, w, n_per_image, n_ps, device, seed):
    """P2-P5 at 256 channels and ROIs, a stride-16 map of 392 channels and
    its ROIs and offsets; every leaf takes a gradient."""
    feats = zoo_features(level_shapes(h, w, (4, 8, 16, 32)), 256, 2, device, seed, grad=True)
    rois = zoo_rois(n_per_image, h, w, 2, device, seed + 1)
    psmap = zoo_features([level_shapes(h, w, (16,))[0]], 392, 2, device, seed + 2, True)[0]
    ps_rois = zoo_rois(n_ps // 2, h, w, 2, device, seed + 3)
    g = torch.Generator().manual_seed(seed + 4)
    trans = (torch.randn(n_ps, 2, 7, 7, generator=g) * 0.3).to(device).requires_grad_()
    return feats, rois, psmap, ps_rois, trans


def roi_leaves(mods, key, inputs):
    """The leaves a ROI step's gradient is taken for: its head's parameters
    and the P2-P5 maps, or the PS-ROI map and its offsets."""
    feats, _, psmap, _, trans = inputs
    if key is None:
        return [psmap, trans]
    return [*mods[key].parameters(), *feats]


def roi_run(step, leaves):
    for p in leaves:
        p.grad = None
    losses, outs = step()
    loss_total(losses).backward()
    return losses, outs, [p.grad for p in leaves]


def roi_part(worst) -> None:
    """17c: the ROI path at full width (P2-P5 of an 800 x 1216 image, b2,
    512 ROIs an image; 128 mask ROIs; 64 keypoint ROIs; 300 PS-ROIs with
    offsets on the stride-16 map): forward, losses, backward into the
    heads, the features and the offsets; finite; the fp32 forward twice,
    equal bits; median steps. 17d: the same on a 128 x 192 image, card vs
    CPU (`card_cpu_step`)."""
    import copy

    mods = roi_modules()
    card_mods = {k: copy.deepcopy(m).cuda() for k, m in mods.items()}
    inputs = roi_inputs(*ZOO_IMAGE, 512, 300, "cuda", 190)
    small = roi_inputs(128, 192, 16, 20, "cpu", 195)
    for name, (key, step) in roi_steps(card_mods, *inputs, seed=199).items():
        leaves = roi_leaves(card_mods, key, inputs)
        torch.cuda.reset_peak_memory_stats()
        losses, outs, grads = roi_run(step, leaves)
        finite([v.detach().reshape(1) for v in losses.values()] + outs + grads, f"17c {name}")
        with torch.no_grad():
            equal_bits_all(step()[1], step()[1], f"17c {name}")
        ms = median_eager_ms(lambda: roi_run(step, leaves))
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"17c {name} on {card_line()}: step (forward, loss, backward) {ms:.3f} ms eager "
            f"(median of {ZOO_REPS}), peak {peak:.3f} GiB; "
            f"{', '.join(f'{k} {v.item():.4f}' for k, v in losses.items())}; output shapes "
            f"{[tuple(o.shape) for o in outs]}; finite; two fp32 forwards equal in bits")
        t = time.perf_counter()

        def run(dev, dtype, name=name, key=key):
            ms = {k: in_dtype(copy.deepcopy(m), dtype).to(dev) for k, m in mods.items()}
            feats, rois, psmap, ps_rois, trans = small
            ins = ([f.detach().to(device=dev, dtype=dtype).requires_grad_() for f in feats],
                   rois.to(device=dev, dtype=dtype),
                   psmap.detach().to(device=dev, dtype=dtype).requires_grad_(),
                   ps_rois.to(device=dev, dtype=dtype),
                   trans.detach().to(device=dev, dtype=dtype).requires_grad_())
            losses, _, grads = roi_run(roi_steps(ms, *ins, seed=198)[name][1],
                                       roi_leaves(ms, key, ins))
            return losses, grads

        card_cpu_step(f"17d {name}", run, worst)
        log(f"17d {name}: {time.perf_counter() - t:.3f} s")


def native_part() -> None:
    """17e: the port's native library built here with g++, against
    `ops/nms.py` and `ops/roi_align.py` on the card."""
    from lpi_tpu_torch import native
    from lpi_tpu_torch.ops.nms import ml_nms_mask, nms_mask, soft_nms
    from lpi_tpu_torch.ops.roi_align import roi_align

    if native.compiler() is None:
        raise AssertionError("17e: no C++ compiler (g++) on this host for the native library")
    t = time.perf_counter()
    path = native.build()
    log(f"17e: native library {path.name} built or found in {time.perf_counter() - t:.3f} s")
    rng = np.random.RandomState(200)
    # 200 objects x 10 jittered detections each, in an 800 x 1216 image
    centres = rng.uniform(0, 1, (200, 2)) * (1216, 800)
    sides = np.exp(rng.uniform(np.log(16), np.log(400), (200, 2)))
    c = np.repeat(centres, 10, 0) + rng.randn(2000, 2) * np.repeat(sides, 10, 0) * 0.1
    s = np.repeat(sides, 10, 0) * rng.uniform(0.8, 1.2, (2000, 2))
    boxes = np.concatenate([c - s / 2, c + s / 2], 1).astype(np.float32)
    scores = (rng.permutation(2000) / 2000 * 0.95 + 0.05).astype(np.float32)
    labels = rng.randint(0, ZOO_CLASSES, 2000).astype(np.int32)
    b, sc, lb = (torch.from_numpy(a).cuda() for a in (boxes, scores, labels))

    def kept_in_order(mask):
        idx = np.nonzero(mask.cpu().numpy())[0]
        return idx[np.argsort(-scores[idx], kind="stable")]

    for what, host, card in (
            ("nms_cpu", lambda: native.nms_cpu(boxes, scores, 0.5),
             lambda: kept_in_order(nms_mask(b, sc, 0.5))),
            ("ml_nms_cpu", lambda: native.ml_nms_cpu(boxes, scores, labels, 0.5),
             lambda: kept_in_order(ml_nms_mask(b, sc, lb, 0.5)))):
        t = time.perf_counter()
        want = host()
        t_host = time.perf_counter() - t
        t = time.perf_counter()
        got = card()
        t_card = time.perf_counter() - t
        if not np.array_equal(want, got):
            raise AssertionError(f"17e {what}: {len(want)} kept against {len(got)} on the card")
        log(f"17e {what} on 2,000 boxes: {len(want)} kept, equal to ops/nms.py on the card "
            f"(host {1e3 * t_host:.3f} ms, card {1e3 * t_card:.3f} ms)")
    t = time.perf_counter()
    decayed, kept = native.soft_nms_cpu(boxes, scores, 0.5, 0.001)
    t_host = time.perf_counter() - t
    t = time.perf_counter()
    out, picked = soft_nms(b, sc, sigma=0.5, score_threshold=0.001)
    out, picked = out.cpu().numpy(), picked.cpu().numpy()
    t_card = time.perf_counter() - t
    rel = np.abs(out[picked] - decayed[picked]) / decayed[picked]
    if int(picked.sum()) != kept or not rel.max() <= 1e-4:
        raise AssertionError(f"17e soft_nms_cpu: {kept} kept on the host, {int(picked.sum())} "
                             f"on the card, largest relative difference {rel.max():.3e}")
    log(f"17e soft_nms_cpu on 2,000 boxes: {kept} kept on both, decayed scores within "
        f"relative {rel.max():.3e} (bar 1e-4) of ops/nms.py:soft_nms on the card (host "
        f"{1e3 * t_host:.3f} ms, card {1e3 * t_card:.3f} ms)")
    fmap = torch.from_numpy(rng.randn(1, 50, 76, 256).astype(np.float32))
    rois = zoo_rois(64, 800, 1216, 1, "cpu", 201)
    rois[:, 0] = 0
    want = torch.from_numpy(np.stack([native.roi_align_cpu(fmap[0].numpy(), r[1:].numpy(),
                                                           1 / 16, 7, 2) for r in rois]))
    got = roi_align(fmap.cuda(), rois.cuda(), 7, 1 / 16).cpu()
    assert_close(got.numpy(), want.numpy(), "17e roi_align_cpu (64 ROIs, 50x76x256, 1/16)",
                 where="card (ops/roi_align.py) vs the native library")


def zoo_phase() -> None:
    """Phase 17, the detector zoo at published widths (80 classes, seeded
    weights): 17a backbones, 17b dense heads, 17c the ROI path, 17d every
    module fp32 card vs CPU at a small size, 17e the native library."""
    worst = [0.0, [], 0.0]
    t0 = time.perf_counter()
    for name, build, side, text, want in zoo_backbones():
        backbone_part(name, build, side, text, want, worst)
    log(f"phase 17a (+ its 17d): {time.perf_counter() - t0:.3f} s")
    t = time.perf_counter()
    dense_head_part(worst)
    log(f"phase 17b (+ its 17d): {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    roi_part(worst)
    log(f"phase 17c (+ its 17d): {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    native_part()
    log(f"phase 17e: {time.perf_counter() - t:.3f} s")
    log(f"phase 17d: largest fp32 card-vs-CPU relative Frobenius error {worst[0]:.3e}, "
        f"fp64 (the steps' losses and gradients) {worst[2]:.3e} (bar 1e-4)")
    if worst[1]:
        raise AssertionError(f"phase 17d: {len(worst[1])} comparisons over the bar: {worst[1]}")


# ---- phase 18: the tooling around the full-width main path -----------------
TOOLING_STEPS = 5  # captured steps after the first
EMA_REPS = 5  # EMA updates timed (the median)
HBM_BYTES_PER_S = 3.35e12  # an H100 SXM's memory rate (NVIDIA's data sheet)
FLOP_RATIO_BAR = 0.05


def trace_window_launches(logdir) -> dict:
    """The window kernels' launches, by wrapper, among the device kernels of
    the one Chrome trace that `core.profiling.trace` wrote into `logdir`."""
    (name,) = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
    with open(os.path.join(logdir, name)) as f:
        events = json.load(f)["traceEvents"]
    counts = {}
    for e in events:
        m = WINDOW_KERNEL_NAME.search(e.get("name", "")) if e.get("cat") == "kernel" else None
        if m:
            key = WINDOW_KERNELS[(int(m.group(2)), bool(m.group(1)))]
            counts[key] = counts.get(key, 0) + 1
    log(f"trace {name}: {len(events)} events, {sum(e.get('cat') == 'kernel' for e in events)} "
        f"device kernels, window kernels {counts}")
    return counts


def ema_card_vs_cpu(ema, params):
    """One `update_ema` on the card and the same on the CPU copies: the
    largest relative Frobenius error of a leaf, and whether every leaf is
    equal in bits."""
    from lpi_tpu_torch.core.ema import update_ema

    cpu = update_ema({k: v.cpu() for k, v in ema.items()},
                     {k: v.detach().cpu() for k, v in params.items()})
    card = {k: v.cpu() for k, v in update_ema(ema, params).items()}
    worst = max(rel_frob(card[k].double().numpy(), cpu[k].double().numpy()) for k in cpu)
    return worst, all(torch.equal(card[k], cpu[k]) for k in cpu)


def tooling_step_phase(dk, fk, tok, work):
    """Phase 18a: the port's tooling around phase 5's full-width step
    (`GroundingConfig()`, b4, 448 px, bf16, "pallas", task 1,
    `honest_offsets`), 1 + 5 captured steps under deterministic algorithms:
    `core.profiling.StepTimer` beside the host clock taken as phase 5 takes
    it; one step inside `core.profiling.trace`, its Chrome trace holding 54
    / 24 / 54 / 24 window kernels by name; `device_memory_stats` against the
    allocator; an EMA of every parameter (`core.ema`) updated after each
    step, one update timed beside its byte bound and held on the card
    against the CPU; one eager gradient of `_losses` over every pool leaf
    through `continual.freeze.mask_grads` (row 1 kept, every other row
    zero) and `count_trainable` against the pools' row-1 scalars; the
    losses through `core.logging.MetricLogger` and one `log_line`."""
    from lpi_tpu_torch.bench import deterministic, honest_offsets
    from lpi_tpu_torch.config import GroundingConfig
    from lpi_tpu_torch.continual.freeze import count_trainable, mask_grads
    from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
    from lpi_tpu_torch.core import profiling
    from lpi_tpu_torch.core.ema import init_ema, update_ema
    from lpi_tpu_torch.core.logging import MetricLogger
    from lpi_tpu_torch.data.grounding import synthetic_grounding_task
    from lpi_tpu_torch.graphs import WARMUP

    t = time.perf_counter()
    cfg = GroundingConfig(batch_size=TRAIN_BATCH)
    learner = GroundingLearner(cfg, generator=torch.Generator().manual_seed(0), device="cuda")
    honest_offsets(learner.model)
    batch = next(synthetic_grounding_task(TRAIN_TASK, TRAIN_BATCH, cfg.image_size, tok,
                                          max_boxes=cfg.max_boxes).batches(TRAIN_BATCH))
    params = dict(learner.model.named_parameters())
    ema = init_ema(params)
    log(f"18a: learner and EMA built in {time.perf_counter() - t:.3f} s")
    timer, metrics_log, host = profiling.StepTimer(), MetricLogger(), []
    with deterministic():
        step = learner.make_step(TRAIN_TASK, steps_per_epoch=TOOLING_STEPS,
                                 epochs=cfg.epochs_per_task)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(dk, fk)
        for i in range(1 + TOOLING_STEPS):
            t = time.perf_counter()
            if i:
                timer.start()
            metrics = step(batch)
            if i:
                timer.stop(metrics)  # the card's metrics: it synchronizes
            else:
                torch.cuda.synchronize()
            host.append((time.perf_counter() - t) * 1e3)
            losses = {k: v.item() for k, v in metrics.items()}
            if not all(np.isfinite(v) for v in losses.values()):
                raise AssertionError(f"18a step {i}: {losses}")
            metrics_log.update(**losses)
            ema = update_ema(ema, params)
        launches = launch_counts(dk, fk)
        if launches != expected_counts(dk, fk, cfg, WARMUP + 1, train=True):
            raise AssertionError(f"18a: launch counters {launches}")
        med = statistics.median(host[1:])
        log(f"18a StepTimer on {card_line()}: p50 {timer.p50 * 1e3:.3f} ms, mean "
            f"{timer.mean * 1e3:.3f} ms over {TOOLING_STEPS} captured steps after the first; "
            f"host clock median {med:.3f} ms ({host[0]:.3f} ms the first)")
        if not timer.p50 * 1e3 >= 0.5 * med:
            raise AssertionError("18a: StepTimer did not wait for the card")
        stats = profiling.device_memory_stats("cuda")
        log(f"18a device_memory_stats: {stats} ({stats['peak_bytes_in_use'] / 2**30:.3f} GiB "
            f"peak of {stats['bytes_limit'] / 2**30:.3f} GiB)")
        if not (stats["peak_bytes_in_use"] == torch.cuda.max_memory_allocated()
                and 0 < stats["bytes_in_use"] <= stats["bytes_limit"]):
            raise AssertionError(f"18a: device_memory_stats {stats}")
        logdir = os.path.join(work, "trace")
        t = time.perf_counter()
        with profiling.trace(logdir):
            step(batch)
            torch.cuda.synchronize()
        log(f"18a: one step traced and its trace written in {time.perf_counter() - t:.3f} s")
        got = trace_window_launches(logdir)
        want = {k: n for k, n in expected_counts(dk, fk, cfg, 1, train=True).items() if n}
        if got != want:
            raise AssertionError(f"18a trace: window kernels {got}, want {want}")
        del step
    log(metrics_log.log_line(1 + TOOLING_STEPS, 1 + TOOLING_STEPS, prefix="18a "))

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(EMA_REPS):
        start.record()
        ema = update_ema(ema, params)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    nbytes = sum(3 * p.numel() * p.element_size() for p in params.values())
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    ema_ms = statistics.median(times)
    t = time.perf_counter()
    worst, bits = ema_card_vs_cpu(ema, params)
    log(f"18a: update_ema card vs CPU in {time.perf_counter() - t:.3f} s")
    log(f"18a update_ema on {card_line()}: {len(params)} leaves, "
        f"{sum(p.numel() for p in params.values())} parameters, median {ema_ms:.3f} ms of "
        f"{EMA_REPS} (all {[round(x, 3) for x in times]}), bound {bound:.3f} ms "
        f"({nbytes / 1e9:.3f} GB: read e, read p, write e at 3.35 TB/s), "
        f"{100 * bound / ema_ms:.1f}% of it; card vs CPU largest relative Frobenius "
        f"{worst:.3e} (bar 1e-6), equal in bits: {bits}")
    if not worst <= 1e-6:
        raise AssertionError("18a: update_ema on the card and the CPU disagree")
    del ema

    pools = learner.pools
    names = sorted(pools)
    total, _ = learner._losses(learner.to_device(batch), TRAIN_TASK)
    grads = dict(zip(names, torch.autograd.grad(total, [pools[n] for n in names])))
    masked = mask_grads(grads, TRAIN_TASK)
    others = [i for i in range(cfg.total_tasks) if i != TRAIN_TASK]
    live = [n for n in names if grads[n][others].any()]
    for n in names:
        if not (torch.equal(masked[n][TRAIN_TASK], grads[n][TRAIN_TASK])
                and not masked[n][others].any()):
            raise AssertionError(f"18a mask_grads: {n} is not its row {TRAIN_TASK} alone")
    n_train = count_trainable(params, TRAIN_TASK)
    want_n = sum(p[TRAIN_TASK].numel() for p in pools.values())
    log(f"18a mask_grads: {len(names)} pool leaves keep row {TRAIN_TASK} and zero the rest "
        f"({len(live)} had a gradient in another row: {live}); count_trainable {n_train}, "
        f"the pools' row-{TRAIN_TASK} scalars {want_n}")
    if n_train != want_n:
        raise AssertionError("18a: count_trainable is not the pools' row")
    del learner, params, pools, grads, masked, total
    torch.cuda.empty_cache()


def flops_phase():
    """Phase 18b: `core.profiling.compiled_flops` over one eager
    full-width retrieval step (`RetrievalConfig()`: CLIP ViT-B/16, b64,
    the LPI pool; after one warm-up step) beside `retrieval_step_flops`,
    which counts the towers' products: within 5%."""
    from lpi_tpu_torch.bench import retrieval_inputs
    from lpi_tpu_torch.config import RetrievalConfig
    from lpi_tpu_torch.continual.learner import RetrievalLearner
    from lpi_tpu_torch.core.profiling import compiled_flops

    cfg = RetrievalConfig()
    learner = RetrievalLearner(cfg, generator=torch.Generator().manual_seed(0), device="cuda")
    batch = learner.to_device(retrieval_inputs(cfg))
    step = learner.make_train_step(TRAIN_TASK, steps_per_epoch=100, epochs=cfg.epochs,
                                   eager=True)
    step(batch)
    torch.cuda.synchronize()
    t = time.perf_counter()
    counted = compiled_flops(step, batch)
    torch.cuda.synchronize()
    want = retrieval_step_flops(cfg)
    ratio = counted["flops"] / want
    log(f"18b compiled_flops of one eager retrieval step (b{cfg.batch_size}): "
        f"{counted['flops'] / 1e12:.6f} TFLOP in {time.perf_counter() - t:.3f} s, "
        f"retrieval_step_flops {want / 1e12:.6f} TFLOP, ratio {ratio:.6f} "
        f"(bar 1 +- {FLOP_RATIO_BAR}); {counted}")
    if not abs(ratio - 1) <= FLOP_RATIO_BAR:
        raise AssertionError(f"18b: the FLOP count is {ratio:.4f} of the products'")
    del learner, batch, step
    torch.cuda.empty_cache()


def stub_gradio():
    """A `gradio` module whose `Interface` records its `fn` and whose
    `launch` returns at once. -> (the module, the recorded dict)."""
    import types

    gr, recorded = types.ModuleType("gradio"), {}

    class Interface:
        def __init__(self, fn, **kwargs):
            recorded["fn"] = fn

        def launch(self, **kwargs):
            recorded["launch"] = kwargs

    gr.Interface = Interface
    gr.Textbox = gr.Image = gr.Dropdown = lambda *args, **kwargs: None
    return gr, recorded


def serve_phase(dk, fk):
    """Phase 18c: `serve` at full width on the card (`GroundingConfig()`, no
    checkpoint) with a stub `gradio`; the recorded `infer` on a seeded
    480x640 image with "all" and "R@1", each equal pixel for pixel to
    `draw_predictions` / `draw_predictions_metric` of the same predictor's
    `predict`; at the config's thresholds, then at 0 (seeded weights score
    every box near the prior); the launch counters over the requests (one
    capture) and one profiled request's window kernels by name (54 / 24)."""
    import importlib.util

    from lpi_tpu_torch.graphs import WARMUP
    from lpi_tpu_torch.serve.predictor import draw_predictions, draw_predictions_metric

    log(f"18c: gradio importable on this machine: "
        f"{importlib.util.find_spec('gradio') is not None}")
    gr, recorded = stub_gradio()
    real = sys.modules.get("gradio")
    sys.modules["gradio"] = gr
    try:
        predictor, wall, _ = run_cli("serve", "--port", "7861")
    finally:
        if real is None:
            del sys.modules["gradio"]
        else:
            sys.modules["gradio"] = real
    if recorded.get("launch") != {"server_port": 7861}:
        raise AssertionError(f"18c: launch got {recorded.get('launch')}")
    infer, cfg = recorded["fn"], predictor.model.cfg
    image = np.random.RandomState(0).randint(0, 256, size=(480, 640, 3)).astype(np.uint8)
    reset_counts(dk, fk)
    requests = 0
    for thresholds in ("the config's", "0"):
        if thresholds == "0":
            predictor.score_thresh = 0.0
            predictor.atss_cfg = dataclasses.replace(predictor.atss_cfg, inference_thresh=0.0)
        views = {view: np.asarray(infer(CLI_CAPTION, image, view)) for view in ("all", "R@1")}
        result = predictor.predict(image, CLI_CAPTION)
        requests += 3
        want = {"all": np.asarray(draw_predictions(image, result)),
                "R@1": np.asarray(draw_predictions_metric(image, result, metric="R@1")[0])}
        for view in views:
            if not np.array_equal(views[view], want[view]):
                raise AssertionError(f"18c infer {view!r} at thresholds {thresholds}: not the "
                                     f"drawing of predict")
        log(f"18c infer at thresholds {thresholds}: {len(result['boxes'])} detections, "
            f"'all' and 'R@1' equal to the drawings of predict pixel for pixel "
            f"({views['all'].shape})")
    launches = launch_counts(dk, fk)
    if launches != expected_counts(dk, fk, cfg, WARMUP + 1, train=False):
        raise AssertionError(f"18c: launch counters {launches} over {requests} requests")
    kernels, _ = _profile(lambda: infer(CLI_CAPTION, image, "all"), "serve request")
    per_request = check_replay_launches(dk, fk, cfg, kernels, False, "18c serve")
    log(f"18c: launch counters {launches} over {requests} requests (one capture of "
        f"{WARMUP + 1} host calls), {per_request} by kernel name a request")
    del predictor, infer, recorded
    torch.cuda.empty_cache()


def tooling_phase(dk, fk, tok=None):
    """Phase 18: 18a, 18b and 18c, with 18a's trace in a temporary
    directory deleted afterwards. `tok`: the grounding tokenizer (built
    here when None)."""
    import shutil
    import tempfile

    if tok is None:
        from lpi_tpu_torch.config import GroundingConfig
        from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer

        bert = GroundingConfig().bert
        tok = BertTokenizer(max_len=bert.max_query_len, vocab_size=bert.vocab_size)
    work = tempfile.mkdtemp(prefix="chip_smoke_tooling_")
    try:
        t = time.perf_counter()
        tooling_step_phase(dk, fk, tok, work)
        log(f"phase 18a: {time.perf_counter() - t:.3f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t = time.perf_counter()
    flops_phase()
    log(f"phase 18b: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    serve_phase(dk, fk)
    log(f"phase 18c: {time.perf_counter() - t:.3f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from lpi_tpu_torch.config import GroundingConfig
    from lpi_tpu_torch.continual.keys import TaskKeys
    from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
    from lpi_tpu_torch.models.glip.grounding import GroundedVLModel, init_parameters
    from lpi_tpu_torch.ops import cuda_build
    from lpi_tpu_torch.ops import deform_window_kernel as dk
    from lpi_tpu_torch.ops import fused_deform_kernel as fk

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    cuda_build.build()
    log(f"build: {time.perf_counter() - t0:.3f} s")

    window = "lpi_tpu/ops/deform_window_kernel.py"
    fused = "lpi_tpu/ops/fused_deform_kernel.py"
    fused_src = "lpi_tpu_torch/csrc/fused_deform.cu"
    # the upsample replaces no Pallas kernel: the JAX package's XLA resize
    resize = "lpi_tpu/models/glip/vldyhead.py:187 (jax.image.resize, no pallas_call)"
    resize_src = "lpi_tpu_torch/csrc/resize_bilinear.cu"
    records = {name: _record(name, replaces, *src) for name, replaces, *src in (
        ("window_accumulate_taps_inpad", f"{window}:534"),
        ("window_accumulate_taps_s2", f"{window}:766"),
        ("window_accumulate_taps_inpad_backward", f"{window}:597"),
        ("window_accumulate_taps_s2_backward", f"{window}:823"),
        ("fused_deform", f"{fused}:181", fused_src),
        ("fused_deform_backward", f"{fused}:225", fused_src),
        ("window_accumulate_taps", f"{window}:287"),
        ("window_accumulate_taps_backward", f"{window}:341"),
        ("window_accumulate", f"{window}:883"),
        ("window_accumulate_backward", f"{window}:921"),
        ("resize_bilinear_forward", resize, resize_src),
        ("resize_bilinear_backward", resize, resize_src))}
    records["fused_deform"]["pallas_call"] = f"{fused}:201"
    records["fused_deform_backward"]["pallas_call"] = f"{fused}:238"
    for name, line in zip(PADDED_KERNELS, (320, 357, 897, 926)):
        records[name]["pallas_call"] = f"{window}:{line}"
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_forward_kernels(dk, gen, records)
    check_backward_kernels(dk, gen, records)
    t = time.perf_counter()
    check_fused_kernels(fk, gen, records)
    log(f"phase 2c: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    check_resize_kernels(gen, records)
    log(f"phase 2d: {time.perf_counter() - t:.3f} s; phases 1-2d: "
        f"{time.perf_counter() - t0:.3f} s")

    # ---- the full-width predictor: GLIP-T + LPI at 448 px, bf16 ---------
    t = time.perf_counter()
    cfg = GroundingConfig(batch_size=TRAIN_BATCH)
    cfg_fused = dataclasses.replace(cfg, dyhead=dataclasses.replace(cfg.dyhead,
                                                                    deform_impl="fused"))
    model = GroundedVLModel(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    feat_dim = cfg.dyhead.channels * 4 * 4  # P7 at 448 px
    centers = (rng.randn(cfg.total_tasks, cfg.num_key_clusters, feat_dim)
               / np.sqrt(feat_dim)).astype(np.float32)
    keys = TaskKeys(torch.from_numpy(centers), torch.ones(cfg.total_tasks, dtype=torch.bool))
    tok = BertTokenizer(max_len=cfg.bert.max_query_len, vocab_size=cfg.bert.vocab_size)
    image = rng.randint(0, 256, size=(480, 640, 3)).astype(np.uint8)
    caption = "a red car parked next to a tall tree and a small dog"
    predictor, launches, per_request = predict_phase(dk, fk, model, keys, tok, cfg, image,
                                                     caption)
    for name in ("window_accumulate_taps_inpad", "window_accumulate_taps_s2",
                 "resize_bilinear_forward"):
        records[name]["predict_launches"] = launches[name]
        records[name]["replay_launches_per_request"] = per_request[name]
    model_fused = GroundedVLModel(cfg_fused)
    model_fused.load_state_dict(model.state_dict())
    predictor_fused, launches, per_request = predict_phase(dk, fk, model_fused, keys, tok,
                                                           cfg_fused, image, caption)
    records["fused_deform"]["predict_launches"] = launches["fused_deform"]
    records["fused_deform"]["replay_launches_per_request"] = per_request["fused_deform"]
    log(f"phases 3, 3b: {time.perf_counter() - t:.3f} s")

    # ---- fp32: the card against the CPU, and fused against "pallas" -----
    t = time.perf_counter()
    canvas, _ = predictor._prepare_image(image)
    ids, mask, _ = tok([caption])
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cfg32_fused = dataclasses.replace(cfg_fused, dtype="float32")
    cut32 = dataclasses.replace(cpu_depth_cut(cfg), dtype="float32")
    compare_heads(fp32_heads(model, cut32, keys, canvas, ids, mask, "cuda"),
                  fp32_heads(model, cut32, keys, canvas, ids, mask, "cpu"), "card vs cpu")
    compare_heads(fp32_heads(model, cfg32_fused, keys, canvas, ids, mask, "cuda"),
                  fp32_heads(model, cfg32, keys, canvas, ids, mask, "cuda"),
                  "fused vs pallas, card")
    del predictor, predictor_fused, model, model_fused
    torch.cuda.empty_cache()
    log(f"phases 4, 3b fp32: {time.perf_counter() - t:.3f} s")

    # ---- the full-width train steps, then their fp32 gradients ----------
    for c in (cfg, cfg_fused):
        t = time.perf_counter()
        batch = train_phase(dk, fk, c, tok, records)
        gradient_phase(cpu_depth_cut(c), batch)
        log(f"phases 5-6 ({c.dyhead.deform_impl}): {time.perf_counter() - t:.3f} s")

    # ---- the quality gates, phases 7 and 10 at once -----------------------
    t = time.perf_counter()
    gate_phase()
    log(f"phases 7 and 10: {time.perf_counter() - t:.3f} s")

    # ---- rows 3 and 4 and their path, the deform-window microbenchmark ---
    t = time.perf_counter()
    microbenchmark_phase(dk, fk, gen, records)
    log(f"phase 8: {time.perf_counter() - t:.3f} s")

    # ---- continual retrieval: the SliNet step and its gradient -----------
    t = time.perf_counter()
    retrieval_train_phase(dk, fk)
    log(f"phase 9: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    retrieval_gradient_phase()
    log(f"phase 9b: {time.perf_counter() - t:.3f} s")

    # ---- the grounding bench line ----------------------------------------
    t = time.perf_counter()
    grounding_bench_phase()
    log(f"phase 11: {time.perf_counter() - t:.3f} s")

    # ---- the command line, its checkpoints and restore -------------------
    t = time.perf_counter()
    cli_phase(dk, fk, gen, records)
    log(f"phase 12: {time.perf_counter() - t:.3f} s")

    # ---- the baseline prompt types ---------------------------------------
    t = time.perf_counter()
    baseline_phase(dk, fk, tok)
    log(f"phase 13: {time.perf_counter() - t:.3f} s")

    # ---- the head variants and GLIP-KNOW's detection mode ----------------
    t = time.perf_counter()
    variants_phase(dk, fk, tok, records)
    log(f"phase 14: {time.perf_counter() - t:.3f} s")

    # ---- the distributed steps: a process group, a mesh ------------------
    t = time.perf_counter()
    mesh_phase()
    log(f"phase 15: {time.perf_counter() - t:.3f} s")

    # ---- datasets, multi-scale training and TTA, eval-detection ----------
    t = time.perf_counter()
    multiscale_phase(dk, fk, gen, tok, records)
    log(f"phase 16: {time.perf_counter() - t:.3f} s")
    log(f"phases 1-16: {time.perf_counter() - t0:.3f} s after the start of the build")

    # ---- the detector zoo: backbones, heads, ROI ops, the native library -
    t = time.perf_counter()
    zoo_phase()
    log(f"phase 17: {time.perf_counter() - t:.3f} s")

    # ---- the tooling around the main path: timer, trace, EMA, FLOPs, serve
    t = time.perf_counter()
    tooling_phase(dk, fk, tok)
    log(f"phase 18: {time.perf_counter() - t:.3f} s")

    for rec in records.values():
        kinds = rec.pop("bound_kinds")
        rec["bound_by"] = "bytes" if kinds == {"bytes"} else "operations"
    log(f"chip_smoke: {time.perf_counter() - t0:.3f} s after the start of the build")
    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
