"""Quickest proof that the PyTorch port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and `nvcc` for sm_90a. Phases (any failure exits
non-zero):

1. build every CUDA kernel of the port from `lpi_tpu_torch/csrc/`;
2. hold each forward kernel against its plain PyTorch version on the card at
   every shape the 448 px grounding predictor (batch 1) and train step
   (batch 4) give it, in fp32 and bf16, and time both (CUDA graphs, median
   of 20);
   2b. the same for the two backward kernels at the train step's shapes;
3. drive the full-width GLIP-T + LPI grounding predictor
   (`lpi_tpu_torch.serve.predictor.GroundingPredictor`, `GroundingConfig()`
   defaults, seeded random weights and task keys) through a few requests,
   with the kernels' launch counters checked, and profile one request;
4. run the same model in fp32 on the card and on the CPU (plain versions)
   and compare the head outputs and the inferred task id;
5. drive the full-width continual-grounding train step
   (`lpi_tpu_torch.continual.grounding_learner.GroundingLearner`, batch 4,
   448 px, bf16, task 1) for 1 + 10 steps with the launch counters checked,
   the frozen parameters and the other tasks' pool rows checked unchanged,
   and one step profiled;
6. compute one fp32 `_losses` and its pool gradients at batch 1 on the card
   and on the CPU from the same seeded weights and compare them.

The last lines are the kernels' JSON record, the card's name and power
limit, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # fp32 outside the tensor cores
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


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def _median_event_ms(run, reps: int, inner: int) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def device_time_ms(fn, reps: int = 20, inner: int = 1) -> float:
    """Device time of one call: `inner` calls captured in a CUDA graph,
    replayed `reps` times between CUDA events; the median per call. The
    graph takes the host's launch cost out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_event_ms(graph.replay, reps, inner)


def eager_time_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Time per call of `inner` back-to-back eager calls: where the host
    cannot keep up with the device, this is the host's cost per call."""
    for _ in range(3):
        fn()

    def run():
        for _ in range(inner):
            fn()

    return _median_event_ms(run, reps, inner)


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(h_all: torch.Tensor, oy: torch.Tensor, Cout: int):
    """Least time for the window sum: bytes (h_all, offsets and gate read
    once, out written once) over HBM rate vs fp32 FMAs of 4 corners x K taps
    per output value over the fp32 rate."""
    B, _, Ho, Wo = oy.shape
    nbytes = (h_all.numel() * h_all.element_size() + 3 * oy.numel() * 4
              + B * Ho * Wo * Cout * 4)
    return _bound(nbytes, B * Ho * Wo * Cout * K * 4 * 2)


def backward_bound_ms(h_all: torch.Tensor, oy: torch.Tensor, Cout: int):
    """Least time for the VJP: h_all, ct and the three offset maps read
    once; d h_all and the three gradient maps written once; vs the fp32
    flops of the corner dot products and the d h_all terms (4 corners x 2
    flops per tap and channel, each)."""
    B, _, Ho, Wo = oy.shape
    nbytes = (2 * h_all.numel() * h_all.element_size() + B * Ho * Wo * Cout * 4
              + 6 * oy.numel() * 4)
    return _bound(nbytes, B * Ho * Wo * Cout * K * 4 * 2 * 2)


def kernel_inputs(gen, side: int, stride: int, dtype, batch: int, Cout: int = 256):
    """Product map, offsets (uniform in [-m, m], with exact integers and the
    +-m edges mixed in), gate (with exact 0 and 1 entries) and a
    cotangent."""
    Ho = (side + stride - 1) // stride
    h = torch.randn(batch, side, side, K * Cout, device="cuda", generator=gen).to(dtype)
    oy = (torch.rand(batch, K, Ho, Ho, device="cuda", generator=gen) * 2 - 1) * M
    ox = (torch.rand(batch, K, Ho, Ho, device="cuda", generator=gen) * 2 - 1) * M
    oy.view(-1)[::7] = torch.round(oy.view(-1)[::7])
    ox.view(-1)[::5] = torch.round(ox.view(-1)[::5])
    oy.view(-1)[::11] = float(M)
    ox.view(-1)[::13] = -float(M)
    gate = torch.rand(batch, K, Ho, Ho, device="cuda", generator=gen)
    gate.view(-1)[::6] = 0.0
    gate.view(-1)[::17] = 1.0
    ct = torch.randn(batch, Ho, Ho, Cout, device="cuda", generator=gen)
    return h.contiguous(), oy.contiguous(), ox.contiguous(), gate.contiguous(), ct


def _record(name, source_line):
    return {"name": name, "route": "cuda", "source": "lpi_tpu_torch/csrc/deform_window.cu",
            "replaces": f"lpi_tpu/ops/deform_window_kernel.py:{source_line}",
            "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
            "library_ms": None, "bound_kinds": set()}


def check_forward_kernels(dk, gen, records):
    """Phase 2: the forward kernels at the predictor's (batch 1) and the
    train step's (batch 4) shapes; the record sums the train step's launches
    (bf16 maps), `predict_ms` the predictor's."""
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
                    got = fn(*args)
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    scale = max(1.0, want.abs().max().item())
                    if not (err <= REL_TOL * scale and torch.isfinite(got).all()):
                        raise AssertionError(f"{name} {dtype} b{batch} side {side}: max abs "
                                             f"err {err} > {REL_TOL} x {scale}")
                    rec["max_abs_err"] = max(rec["max_abs_err"], err)
                    ms = device_time_ms(lambda: fn(*args), inner=10)
                    plain = device_time_ms(lambda: ref_fn(*args))
                    eager = eager_time_ms(lambda: fn(*args))
                    bms, kind = bound_ms(h, oy, 256)
                    log(f"kernel {name} {str(dtype)[6:]} b{batch} in {side}x{side}x{K * 256} "
                        f"stride {stride}: {ms:.6f} ms, plain {plain:.6f} ms, bound "
                        f"{bms:.6f} ms ({kind}), eager call {eager:.6f} ms, max abs "
                        f"err {err:.3e} (tol {REL_TOL} x {scale:.3f})")
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
    since the kernel rounds its fp32 sum to bf16 once."""
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
                got = fn(*args)
                want = ref_fn(h.float(), oy, ox, g, ct, M, K, KW)
                torch.cuda.synchronize()
                if got[0].dtype != dtype:
                    raise AssertionError(f"{name}: d h_all is {got[0].dtype}, want {dtype}")
                errs = []
                for what, a, b in zip(("dh", "doy", "dox", "dgate"), got, want):
                    a = a.float()
                    scale = max(1.0, b.abs().max().item())
                    bar = REL_TOL * scale
                    excess = (a - b).abs() - bar
                    if what == "dh" and dtype == torch.bfloat16:
                        excess = excess - 2.0 ** -8 * b.abs()
                    err = (a - b).abs().max().item()
                    if not (excess.max().item() <= 0 and torch.isfinite(a).all()):
                        raise AssertionError(f"{name} {dtype} side {side} {what}: max abs "
                                             f"err {err} over the bar")
                    errs.append(f"{what} {err:.3e}")
                    if what != "dh" or dtype == torch.float32:
                        rec["max_abs_err"] = max(rec["max_abs_err"], err)
                ms = device_time_ms(lambda: fn(*args), inner=10)
                plain = device_time_ms(lambda: ref_fn(*args))
                bms, kind = backward_bound_ms(h, oy, 256)
                log(f"kernel {name} {str(dtype)[6:]} b{TRAIN_BATCH} in {side}x{side}x{K * 256} "
                    f"stride {stride}: {ms:.6f} ms, plain {plain:.6f} ms, bound {bms:.6f} ms "
                    f"({kind}), max abs err {', '.join(errs)}")
                if dtype == torch.bfloat16:
                    n = per_tower * TOWERS
                    rec["ms"] += n * ms
                    rec["plain_ms"] += n * plain
                    rec["bound_ms"] += n * bms
                    rec["bound_kinds"].add(kind)


def _profile(run, what):
    """`run()` under torch.profiler: wall time, the device's busy time (the
    sum of its kernels' times), the host ranges and the kernels that take
    the most device time. -> the device kernels' events."""
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
    return kernels


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


def realistic_offsets(model):
    """The offset convs of the seeded model give offsets near 0; scale their
    kernels by 30 and give the first 18 biases N(0, 1), as the JAX package's
    grounding bench does, so that the deform kernels see offsets of a
    trained model's magnitude (about +-1-2 px)."""
    rng = np.random.RandomState(7)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".offset." in name and name.endswith("weight"):
                p.mul_(30.0)
            elif ".offset." in name and name.endswith("bias"):
                bias = np.zeros(p.shape, np.float32)
                bias[:18] = rng.randn(18)
                p.copy_(torch.from_numpy(bias))


def train_phase(dk, cfg, tok, records):
    """Phase 5: the full-width train step, batch 4, 448 px, bf16, task 1.
    -> the batch."""
    from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
    from lpi_tpu_torch.data.grounding import synthetic_grounding_task

    t = time.perf_counter()
    learner = GroundingLearner(cfg, generator=torch.Generator().manual_seed(0), device="cuda")
    realistic_offsets(learner.model)
    log(f"train: learner built in {time.perf_counter() - t:.3f} s; offset convs scaled "
        f"(kernel x30, bias[:18] ~ N(0, 1)) for realistic offsets")
    ds = synthetic_grounding_task(TRAIN_TASK, TRAIN_BATCH, cfg.image_size, tok,
                                  max_boxes=cfg.max_boxes)
    batch = next(ds.batches(TRAIN_BATCH))
    before = {n: p.detach().clone() for n, p in learner.model.named_parameters()}
    step = learner.make_step(TRAIN_TASK, steps_per_epoch=10, epochs=cfg.epochs_per_task)

    torch.cuda.reset_peak_memory_stats()
    totals, times = [], []
    n_steps = 10
    for i in range(1 + n_steps):
        if i == 1:
            dk.reset_launch_counts()
        t = time.perf_counter()
        metrics = step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        totals.append(metrics["total"].item())
        for k, v in metrics.items():
            if not np.isfinite(v.item()):
                raise AssertionError(f"train step {i}: {k} = {v.item()}")
    launches = {fn.__name__: fn.launches for fn in dk.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    # per tower: conv_same at every level and conv_up at all but the last
    # (stride 1), conv_down at all but the first (stride 2); each backward
    # kernel once per forward launch: 54 / 24 / 54 / 24 at six towers
    levels, towers = len(cfg.atss.anchor_strides), cfg.dyhead.num_convs
    s1, s2 = towers * (2 * levels - 1) * n_steps, towers * (levels - 1) * n_steps
    want = {"window_accumulate_taps_inpad": s1, "window_accumulate_taps_s2": s2,
            "window_accumulate_taps_inpad_backward": s1,
            "window_accumulate_taps_s2_backward": s2}
    log(f"train: {n_steps} steps, launches {launches}")
    if launches != want:
        raise AssertionError(f"want {want} launches, got {launches}")
    for name, n in launches.items():
        records[name]["launches"] = n
    med = statistics.median(times[1:])
    log(f"train step on {card_line()}: median {med:.3f} ms over {n_steps} steps after the "
        f"first ({times[0]:.3f} ms), {1e3 * TRAIN_BATCH / med:.3f} samples/s, all "
        f"{[round(x, 3) for x in times]}")
    log(f"train: total loss first {totals[0]:.6f}, last {totals[-1]:.6f}; "
        f"num_pos {metrics['num_pos'].item():.0f}; "
        + ", ".join(f"{k} {v.item():.6f}" for k, v in metrics.items()))
    log(f"train: peak device memory {peak / 2**30:.3f} GiB (max_memory_allocated)")

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
    log(f"train: frozen parameters and the other tasks' pool rows bit-identical; "
        f"{changed} of {len(learner.pools)} pool leaves moved their task-{TRAIN_TASK} row")
    del before

    kernels = _profile(lambda: step(batch), "train step")
    names = {(1, False): "window_accumulate_taps_inpad", (2, False): "window_accumulate_taps_s2",
             (1, True): "window_accumulate_taps_inpad_backward",
             (2, True): "window_accumulate_taps_s2_backward"}
    for key, (n, ms) in sorted(deform_kernel_times(kernels).items()):
        log(f"profile deform kernel {names[key]}: {ms:.3f} ms device in one step, x{n}")
    del learner, step
    torch.cuda.empty_cache()
    return batch


def gradient_phase(cfg, batch):
    """Phase 6: one fp32 `_losses` at task 1 and the gradient of the task-1
    rows of the pools, at batch 1, on the card and on the CPU (plain
    versions), from the same seeded weights: each loss term and the
    concatenated gradient within the repo's bar, relative Frobenius 1e-4.
    (From trained weights with the scaled offset convs the fp32 gradient
    moves by 1e-3 to 1e-2 between two summation orders, on the CPU alone;
    `scripts/torch_grad_order.py` measures that.)"""
    from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
    from lpi_tpu_torch.continual.keys import exact_fp32

    cfg32 = dataclasses.replace(cfg, dtype="float32", batch_size=1)
    one = {k: v[:1] for k, v in batch.items()}
    out = {}
    for device in ("cuda", "cpu"):
        learner = GroundingLearner(cfg32, generator=torch.Generator().manual_seed(0),
                                   device=device)
        t = time.perf_counter()
        with exact_fp32():
            total, metrics = learner._losses(learner.to_device(one), TRAIN_TASK)
            names = sorted(learner.pools)
            grads = torch.autograd.grad(total, [learner.pools[n] for n in names])
        out[device] = ({k: v.item() for k, v in metrics.items()} | {"total": total.item()},
                       {n: g[TRAIN_TASK].double().cpu().numpy() for n, g in zip(names, grads)})
        log(f"fp32 losses + backward on {device}: {time.perf_counter() - t:.3f} s")
        del learner, grads
    (m_gpu, g_gpu), (m_cpu, g_cpu) = out["cuda"], out["cpu"]
    if m_gpu["num_pos"] != m_cpu["num_pos"]:
        raise AssertionError(f"num_pos differs: {m_gpu['num_pos']} vs {m_cpu['num_pos']}")
    for k in sorted(m_cpu):
        if k == "num_pos":
            continue
        if not np.isfinite(m_gpu[k]):
            raise AssertionError(f"fp32 {k} not finite on the card")
        assert_close(m_gpu[k], m_cpu[k], k, atol=np.inf)
    for n in sorted(g_cpu):
        a, b = g_gpu[n], g_cpu[n]
        log(f"fp32 card vs cpu grad {n}[{TRAIN_TASK}]: rel frobenius "
            f"{np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30):.3e}")
    assert_close(np.concatenate([g_gpu[n].ravel() for n in sorted(g_gpu)]),
                 np.concatenate([g_cpu[n].ravel() for n in sorted(g_cpu)]),
                 f"task-{TRAIN_TASK} pool gradient", atol=np.inf)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from lpi_tpu_torch.config import GroundingConfig
    from lpi_tpu_torch.continual.keys import TaskKeys, exact_fp32, infer_task_ids
    from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
    from lpi_tpu_torch.models.glip.grounding import GroundedVLModel, init_parameters
    from lpi_tpu_torch.ops import cuda_build
    from lpi_tpu_torch.ops import deform_window_kernel as dk
    from lpi_tpu_torch.serve.predictor import GroundingPredictor

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    cuda_build.build()
    log(f"build: {time.perf_counter() - t0:.3f} s")

    records = {name: _record(name, line) for name, line in (
        ("window_accumulate_taps_inpad", 534), ("window_accumulate_taps_s2", 766),
        ("window_accumulate_taps_inpad_backward", 597),
        ("window_accumulate_taps_s2_backward", 823))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_forward_kernels(dk, gen, records)
    check_backward_kernels(dk, gen, records)
    log(f"phases 1-2b: {time.perf_counter() - t0:.3f} s")

    # ---- the full-width predictor: GLIP-T + LPI at 448 px, bf16 ---------
    cfg = GroundingConfig(batch_size=TRAIN_BATCH)
    model = GroundedVLModel(cfg)
    init_parameters(model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    feat_dim = cfg.dyhead.channels * 4 * 4  # P7 at 448 px
    centers = (rng.randn(cfg.total_tasks, cfg.num_key_clusters, feat_dim)
               / np.sqrt(feat_dim)).astype(np.float32)
    keys = TaskKeys(torch.from_numpy(centers),
                    torch.ones(cfg.total_tasks, dtype=torch.bool))
    tok = BertTokenizer(max_len=cfg.bert.max_query_len, vocab_size=cfg.bert.vocab_size)
    # random weights score every box near the 0.01 prior: drop the pre-NMS
    # threshold so that all candidates reach NMS and the reply is not empty
    atss = dataclasses.replace(cfg.atss, inference_thresh=0.0)
    predictor = GroundingPredictor(model, keys, tok, image_size=cfg.image_size,
                                   score_thresh=0.0, atss_cfg=atss, device="cuda")
    image = rng.randint(0, 256, size=(480, 640, 3)).astype(np.uint8)
    caption = "a red car parked next to a tall tree and a small dog"

    n_req = 11
    dk.reset_launch_counts()
    lat = []
    for _ in range(n_req):
        t = time.perf_counter()
        result = predictor.predict(image, caption)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    launches = {fn.__name__: fn.launches for fn in dk.KERNELS}
    log(f"predict: {n_req} requests, launches {launches}")
    if launches != {"window_accumulate_taps_inpad": 54 * n_req,
                    "window_accumulate_taps_s2": 24 * n_req,
                    "window_accumulate_taps_inpad_backward": 0,
                    "window_accumulate_taps_s2_backward": 0}:
        raise AssertionError(f"want 54 and 24 launches per forward, got {launches}")
    for name in ("window_accumulate_taps_inpad", "window_accumulate_taps_s2"):
        records[name]["predict_launches"] = launches[name]
    boxes, scores = result["boxes"], result["scores"]
    if not (boxes.ndim == 2 and boxes.shape[1] == 4 and len(boxes) == len(scores)
            == len(result["entities"]) and len(boxes) > 0
            and np.isfinite(boxes).all() and np.isfinite(scores).all()
            and 0 <= result["task_id"] < cfg.total_tasks):
        raise AssertionError(f"bad predict output: {result}")
    log(f"predict: entities {sorted(set(result['entities']))}, {len(boxes)} boxes, "
        f"top score {float(scores.max()):.4f}, task_id {result['task_id']}")
    log(f"predict latency on {card}: median {statistics.median(lat[1:]):.3f} ms over "
        f"{n_req - 1} requests after the first ({lat[0]:.3f} ms), all "
        f"{[round(x, 3) for x in lat]}")

    _profile(lambda: predictor.predict(image, caption), "request")

    # ---- fp32: the card against the CPU's plain versions ----------------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    canvas, _ = predictor._prepare_image(image)
    ids, mask, _ = tok([caption])
    outs = {}
    for device in ("cuda", "cpu"):
        m32 = GroundedVLModel(cfg32)
        m32.load_state_dict(model.state_dict())
        m32 = m32.to(device).eval()
        t = time.perf_counter()
        with torch.no_grad(), exact_fp32():
            images = torch.from_numpy(canvas).to(device)
            sel = infer_task_ids(m32.extract_features(images), keys.to(device))
            flat, _ = m32.forward_tasks(images, torch.from_numpy(ids).long().to(device),
                                        torch.from_numpy(mask).to(device), sel)
        outs[device] = {k: flat[k].float().cpu().numpy()
                        for k in ("dot_logits", "bbox_pred", "centerness")}
        outs[device]["task_id"] = int(sel[0])
        log(f"fp32 forward on {device}: {time.perf_counter() - t:.3f} s, "
            f"task_id {outs[device]['task_id']}")
    for k in ("dot_logits", "bbox_pred", "centerness"):
        if not np.isfinite(outs["cuda"][k]).all():
            raise AssertionError(f"fp32 {k} not finite on the card")
        assert_close(outs["cuda"][k], outs["cpu"][k], k)
    if outs["cuda"]["task_id"] != outs["cpu"]["task_id"]:
        raise AssertionError("task_id differs between card and cpu")
    del predictor, model, m32
    torch.cuda.empty_cache()

    # ---- the full-width train step, then its fp32 gradient --------------
    t = time.perf_counter()
    batch = train_phase(dk, cfg, tok, records)
    log(f"phase 5: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    gradient_phase(cfg, batch)
    log(f"phase 6: {time.perf_counter() - t:.3f} s")

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
