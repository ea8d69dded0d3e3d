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
   defaults, seeded random weights and task keys) through 1 + 11 requests
   eagerly and 1 + 11 captured (its task-id pass and forward replayed as
   CUDA graphs), with the kernels' launch counters checked, one request of
   each profiled with its deform launches read from the kernel names, the
   median latency of each, and equal task ids and detections;
4. run the same model in fp32 on the card and on the CPU (plain versions)
   and compare the head outputs and the inferred task id;
5. drive the full-width continual-grounding train step
   (`lpi_tpu_torch.continual.grounding_learner.GroundingLearner`, batch 4,
   448 px, bf16, task 1, offsets of a trained model's size from
   `lpi_tpu_torch.bench.honest_offsets`) for 1 + 10 steps eagerly and 1 +
   10 captured from the same starting state, under deterministic
   algorithms: the launch counters, every metric and pool leaf captured
   against eager in bits (else the repo's bar, the largest error printed),
   the frozen parameters and the other tasks' pool rows unchanged, and per
   mode the median step, samples/s, a profiled step's busy share and
   kernels, peak memory; the replayed step's deform launches read from
   the kernel names (54 / 24 / 54 / 24);
6. compute one fp32 `_losses` and its pool gradients at batch 1 on the card
   and on the CPU from the same seeded weights and compare them, the
   concatenated gradient and each leaf's (a leaf over the bar read again
   with every module's output on the CPU set to the card's, which puts
   both backwards on the same side of the network's kinks).

The fused deformable conv (`deform_impl="fused"`) and the quality gate:

   2c. hold the fused forward and backward kernels (with and without d W)
       against their plain versions at every shape of the 448 px path
       (batch 1 and 4, 256 channels) and of the gate's config (16
       channels, 64 px), with one launch counted per call and two calls of
       each equal bit for bit, and time them beside their bounds;
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
       `RetrievalConfig()`: 224 px, batch 64, bf16, task 1) for 1 + 20
       steps eagerly and 1 + 20 captured from the same starting state on
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
       line's batch 16 (bf16 maps), one call each against its plain version
       with the bars of phases 2 and 2b, one launch a call, timed beside
       its bound; 12b: `train-grounding --synthetic --tasks 2 --epochs 1`
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
       `prompt_type="clip"`: 1 + 10 steps eager and 1 + 10 captured from
       the same start, losses finite with the type's keys (the auxiliary
       losses are "lpi"'s alone), captured equal to eager in bits, only
       row 1 of every pool leaf moved (L2P's shared pool included), no
       deform kernel launched, median, samples/s and peak memory; then
       `cluster_task` and `evaluate` on the 2-task set (S-Prompts, CLIP),
       or the named error where the reference has no L2P evaluation; 13b:
       phase 9b's fp32 loss and pool gradient, card vs CPU, for S-Prompts
       and L2P, with L2P's chosen entries equal; 13c: phase 5's step
       ("pallas", batch 4, `honest_offsets`) with the grounding section of
       `sprompts.json` and with `maple.json` (54 / 24 / 54 / 24 launches by
       the counters and by kernel name, captured equal to eager in bits,
       the frozen parameters and other rows unchanged), then one request
       of each trained model eager and captured, equal; 13d: phase 6's
       fp32 loss and pool gradient at batch 1, card vs CPU, each leaf too,
       for both pools (MaPLe's replace mode and the encoder without
       interaction on the card); 13e: `train-grounding --config configs/baselines/maple.json
       --synthetic --tasks 2 --epochs 1` at `GroundingConfig()`, then
       `eval-all --grounding` in a learner seeded 99, equal to the
       training run's head outputs and results in bits.

The head's variants and GLIP-KNOW's detection mode, at `GroundingConfig()`'s
full width with seeded weights:

   14. 14a: the early-fusion request (`dyhead.early_fuse`: a VLFuse at
       embed 2048 over 8 heads between the 4,181 visual tokens and the text,
       and a BERT layer, before each of the 6 towers), 1 + 5 requests eager
       and 1 + 5 captured, equal, 54 / 24 window launches a forward by
       counter and kernel name, then fp32 card vs CPU on the head outputs;
       14b: its train step (b4, task 1, `honest_offsets`, the fusion and
       BERT layers frozen), 1 + 5 steps a mode as phase 5 (54 / 24 / 54 / 24,
       captured equal to eager in bits), and phase 6's fp32 loss and pool
       gradient at batch 1, card vs CPU, each leaf too; 14c:
       `predict_classes` (GLIP-KNOW) on the LPI model with five class names
       and a knowledge json written to a temporary directory, eager and
       captured, equal, 54 / 24 a forward; 14d: the plain head (no
       deformable conv, fusion or DyReLU) and the "exact" route, one request
       each, no deform kernel launched, fp32 card vs CPU; 14e:
       `check_deform_clipping` under its 1% warning at the seeded offsets
       (at 448 px a few offsets of the seeded convs pass +-3) and
       over it with the offset convs scaled, read at `honest_offsets`
       between, each the largest of the convs' recorded shares.

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
# replays (the kernels' of 20)
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
                    plain = device_time_ms(lambda: ref_fn(*args), reps=PLAIN_REPS)
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
                plain = device_time_ms(lambda: ref_fn(*args), reps=PLAIN_REPS)
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
                                           reps=PLAIN_REPS)
                    bms = device_time_ms(lambda: fk.fused_deform_backward(*bargs, need_dw=False))
                    bdw = device_time_ms(lambda: fk.fused_deform_backward(*bargs))
                    bplain = device_time_ms(
                        lambda: fk.fused_deform_backward_reference(*bargs, need_dw=False),
                        reps=PLAIN_REPS)
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


def _profile(run, what):
    """`run()` under torch.profiler: wall time, the device's busy time (the
    sum of its kernels' times), the host ranges and the kernels that take
    the most device time. -> (the device kernels' events, {"wall", "busy"
    (ms), "kernels" (count)})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
        f"device kernels")
    for e in events:
        if e.is_user_annotation and e.device_type == DeviceType.CPU:
            log(f"profile range {e.key}: {e.cpu_time_total / 1e3:.3f} ms host")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        log(f"profile kernel {e.self_device_time_total / 1e3:.3f} ms x{e.count}: "
            f"{e.key[:100]}")
    return kernels, {"wall": wall, "busy": busy, "kernels": sum(e.count for e in kernels)}


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
    names = {(1, False): "window_accumulate_taps_inpad", (2, False): "window_accumulate_taps_s2",
             (1, True): "window_accumulate_taps_inpad_backward",
             (2, True): "window_accumulate_taps_s2_backward"}
    return {names[key]: n for key, (n, _) in deform_kernel_times(kernels).items()}


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


def mode_summary(runs, what: str, batch: int) -> None:
    for mode, r in runs.items():
        st = r["stats"]
        log(f"{what} {mode} on {card_line()}: median {r['med']:.3f} ms, "
            f"{1e3 * batch / r['med']:.3f} samples/s, device busy {st['busy']:.3f} of "
            f"{st['wall']:.3f} ms ({100 * st['busy'] / st['wall']:.1f}%) in a profiled call, "
            f"{st['kernels']} device kernels a call, peak memory {r['peak'] / 2**30:.3f} GiB")


def deform_kernel_times(kernels):
    """Device ms of the four deform window kernels among profiled events,
    by (stride, backward)."""
    out = {}
    for e in kernels:
        m = re.search(r"window_taps(_bwd)?_kernel<[^,]+, (\d)", e.key)
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


def assert_close(ours, theirs, what, rel=1e-4, atol=3e-3, where="card vs cpu"):
    """The repo's composed-output bar: relative Frobenius error <= rel plus
    an absolute per-element cap."""
    ours = np.asarray(ours, np.float64)
    theirs = np.asarray(theirs, np.float64)
    frob = np.linalg.norm(ours - theirs) / max(np.linalg.norm(theirs), 1e-6)
    worst = np.abs(ours - theirs).max()
    log(f"fp32 {where} {what}: rel frobenius {frob:.3e} (bar {rel}), max abs "
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
    dk.reset_launch_counts()
    fk.reset_launch_counts()


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


def train_phase(dk, fk, cfg, tok, records, what=None, keep_model=False, n_steps=10):
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
    log (the route by default). -> the batch, and with `keep_model` the
    trained model too."""
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
            med = statistics.median(times[1:])
            log(f"train step {label} ({mode}) on {card_line()}: median {med:.3f} ms over "
                f"{n_steps} steps after the first ({times[0]:.3f} ms), "
                f"{1e3 * TRAIN_BATCH / med:.3f} samples/s, all {[round(x, 3) for x in times]}")
            log(f"train {label} ({mode}): total loss first {losses[0]['total']:.6f}, last "
                f"{losses[-1]['total']:.6f}; " + ", ".join(f"{k} {v:.6f}"
                                                          for k, v in losses[-1].items()))
            pools = {n: p.detach().clone() for n, p in learner.pools.items()}
            kernels, stats = _profile(lambda: step(batch), f"train step ({label}, {mode})")
            log_deform_kernels(kernels)
            per_step = check_replay_launches(dk, fk, cfg, kernels, True,
                                             f"train {label} ({mode})")
            if route == "fused":
                record_fused_split(kernels, records, expected_counts(dk, fk, cfg, 1, train=True))
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
    names = {(1, False): "window_accumulate_taps_inpad", (2, False): "window_accumulate_taps_s2",
             (1, True): "window_accumulate_taps_inpad_backward",
             (2, True): "window_accumulate_taps_s2_backward"}
    for key, (n, ms) in sorted(deform_kernel_times(kernels).items()):
        log(f"profile deform kernel {names[key]}: {ms:.3f} ms device, x{n}")
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


def predict_phase(dk, fk, model, keys, tok, cfg, image, caption, n_req=11, profile=True,
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
    """The fp32 copy of `model` on `device`: task id and head outputs of one
    image, TF32 off."""
    from lpi_tpu_torch.continual.keys import exact_fp32, infer_task_ids
    from lpi_tpu_torch.models.glip.grounding import GroundedVLModel

    m32 = GroundedVLModel(cfg32)
    m32.load_state_dict(model.state_dict())
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
        rec.update(ms=ms, plain_ms=device_time_ms(plain, reps=PLAIN_REPS), bound_ms=bms)
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
RETRIEVAL_STEPS = 20
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


def retrieval_train_phase(dk, fk, cfg=None, steps=RETRIEVAL_STEPS, what="retrieval"):
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


def check_batch16_kernels(dk, gen, records):
    """Phase 12a: rows 1f, 2f, 1b and 2b at P3 of the 448 px head at the
    command line's batch 16 (bf16 maps), one call of each against its plain
    version with the bars of phases 2 and 2b, one launch a call; device ms
    beside the bound, into the records (`b16_ms`, `b16_bound_ms`)."""
    specs = ((1, dk.window_accumulate_taps_inpad, dk.window_accumulate_taps_inpad_reference,
              dk.window_accumulate_taps_inpad_backward,
              dk.window_accumulate_taps_inpad_backward_reference),
             (2, dk.window_accumulate_taps_s2, dk.window_accumulate_taps_s2_reference,
              dk.window_accumulate_taps_s2_backward,
              dk.window_accumulate_taps_s2_backward_reference))
    for stride, fwd, fwd_ref, bwd, bwd_ref in specs:
        h, oy, ox, g, ct = kernel_inputs(gen, CLI_P3, stride, torch.bfloat16, CLI_BATCH)
        args, bargs = (h, oy, ox, g, M, K, KW), (h, oy, ox, g, ct, M, K, KW)
        where = f"b{CLI_BATCH} in {CLI_P3}x{CLI_P3}x{K * 256} stride {stride}"
        err = _held(f"{fwd.__name__} {where}", _launched_once(fwd, *args), fwd_ref(*args))
        ms = device_time_ms(lambda: fwd(*args), inner=10)
        bound, kind = window_bound_ms(h, oy, 256, offsets=(ox, g, stride, M, KW))
        log(f"kernel {fwd.__name__} bf16 {where} on {card_line()}: {ms:.6f} ms, bound "
            f"{bound:.6f} ms ({kind}, the weighted rows of h; {100 * bound / ms:.1f}% of it), "
            f"max abs err {err:.3e}")
        records[fwd.__name__].update(b16_ms=ms, b16_bound_ms=bound)
        got = _launched_once(bwd, *bargs)
        want = bwd_ref(h.float(), oy, ox, g, ct, M, K, KW)
        errs = [_held(f"{bwd.__name__} {where} {what}", a, b, bf16=what == "dh")
                for what, a, b in zip(("dh", "doy", "dox", "dgate"), got, want)]
        del got, want
        ms = device_time_ms(lambda: bwd(*bargs), inner=10)
        bound, kind = window_bound_ms(h, oy, 256, backward=True)
        log(f"kernel {bwd.__name__} bf16 {where} on {card_line()}: {ms:.6f} ms, bound "
            f"{bound:.6f} ms ({kind}; {100 * bound / ms:.1f}% of it), max abs err "
            f"{', '.join(f'{e:.3e}' for e in errs)} (d h_all bf16)")
        records[bwd.__name__].update(b16_ms=ms, b16_bound_ms=bound)
        del h, oy, ox, g, ct, args, bargs
    torch.cuda.empty_cache()


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
    check_batch16_kernels(dk, gen, records)
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
BASELINE_STEPS = 10


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
    L2P and zero-shot CLIP (`retrieval_train_phase`, 1 + 10 steps a mode);
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
                                  f"retrieval {kind}")
            log(f"phase 13a ({kind}): {time.perf_counter() - t:.3f} s")
        for kind in ("sprompts", "l2p"):
            t = time.perf_counter()
            retrieval_gradient_phase(baseline_config(kind, "retrieval").lpi,
                                     f"retrieval {kind}")
            log(f"phase 13b ({kind}): {time.perf_counter() - t:.3f} s")
        for kind in ("sprompts", "maple"):
            t = time.perf_counter()
            cfg = baseline_config(kind, "grounding", batch_size=TRAIN_BATCH)
            batch, model = train_phase(dk, fk, cfg, tok, {}, f"pallas {kind}", keep_model=True)
            baseline_request(dk, fk, model, cfg, tok)
            del model
            torch.cuda.empty_cache()
            log(f"phase 13c ({kind}): {time.perf_counter() - t:.3f} s")
            t = time.perf_counter()
            log(f"phase 13d ({kind}): fp32 losses and pool gradient, card vs cpu")
            gradient_phase(cfg, batch)
            log(f"phase 13d ({kind}): {time.perf_counter() - t:.3f} s")
        work = tempfile.mkdtemp(prefix="chip_smoke_baselines_")
        try:
            t = time.perf_counter()
            cli_baseline_phase(dk, fk, work)
            log(f"phase 13e: {time.perf_counter() - t:.3f} s")
        finally:
            shutil.rmtree(work, ignore_errors=True)


# ---- phase 14: the head variants and GLIP-KNOW's detection mode ---------------
VARIANT_REQUESTS, VARIANT_STEPS = 5, 5
KNOWLEDGE = {
    "car": {"clean_name": "car", "def_wiki": "a road vehicle with four wheels.",
            "gpt3": ["cars have doors.", "cars drive on roads."]},
    "tree": {"clean_name": "tree", "def_wiki": "a tall perennial woody plant."},
    "dog": {"clean_name": "dog", "def_wiki": "a domesticated carnivorous mammal.",
            "gpt3": ["dogs bark."]},
}
CLASS_NAMES = ["car", "tree", "dog", "person", "bench"]


def seeded_keys(cfg, seed):
    """Task keys for the 448 px model: random unit-scale centres in P7's
    feature space, every task valid."""
    from lpi_tpu_torch.continual.keys import TaskKeys

    rng = np.random.RandomState(seed)
    feat_dim = cfg.dyhead.channels * 4 * 4  # P7 at 448 px
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
    cfg32 = dataclasses.replace(cfg, dtype="float32")
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
    cfg32 = dataclasses.replace(cfg_ef, dtype="float32")
    compare_heads(fp32_heads(model, cfg32, keys, canvas, ids, mask, "cuda"),
                  fp32_heads(model, cfg32, keys, canvas, ids, mask, "cpu"),
                  "early fusion, card vs cpu")
    del model
    torch.cuda.empty_cache()
    log(f"phase 14a: {time.perf_counter() - t:.3f} s")

    t = time.perf_counter()
    step_records = {name: {} for name in records}
    batch = train_phase(dk, fk, cfg_ef, tok, step_records, "pallas early-fused",
                        n_steps=VARIANT_STEPS)
    per_path["early_fuse_step"] = (
        {k: v["launches"] for k, v in step_records.items() if v},
        {k: v["replay_launches_per_step"] for k, v in step_records.items() if v},
        VARIANT_STEPS)
    log("phase 14b: fp32 losses and pool gradient, early fusion, card vs cpu")
    gradient_phase(cfg_ef, batch)
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
        ("window_accumulate_backward", f"{window}:921"))}
    records["fused_deform"]["pallas_call"] = f"{fused}:201"
    records["fused_deform_backward"]["pallas_call"] = f"{fused}:238"
    for name, line in zip(PADDED_KERNELS, (320, 357, 897, 926)):
        records[name]["pallas_call"] = f"{window}:{line}"
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_forward_kernels(dk, gen, records)
    check_backward_kernels(dk, gen, records)
    t = time.perf_counter()
    check_fused_kernels(fk, gen, records)
    log(f"phase 2c: {time.perf_counter() - t:.3f} s; phases 1-2c: "
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
    for name in ("window_accumulate_taps_inpad", "window_accumulate_taps_s2"):
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
    card_pallas = fp32_heads(model, cfg32, keys, canvas, ids, mask, "cuda")
    compare_heads(card_pallas, fp32_heads(model, cfg32, keys, canvas, ids, mask, "cpu"),
                  "card vs cpu")
    compare_heads(fp32_heads(model, cfg32_fused, keys, canvas, ids, mask, "cuda"),
                  card_pallas, "fused vs pallas, card")
    del predictor, predictor_fused, model, model_fused
    torch.cuda.empty_cache()
    log(f"phases 4, 3b fp32: {time.perf_counter() - t:.3f} s")

    # ---- the full-width train steps, then their fp32 gradients ----------
    for c in (cfg, cfg_fused):
        t = time.perf_counter()
        batch = train_phase(dk, fk, c, tok, records)
        gradient_phase(c, batch)
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
