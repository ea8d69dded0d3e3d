"""Quickest proof that the PyTorch port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card and `nvcc` for sm_90a. Phases (any failure exits
non-zero):

1. build every CUDA kernel of the port from `lpi_tpu_torch/csrc/`;
2. hold each kernel against its plain PyTorch version on the card at every
   shape the 448 px grounding predictor gives it, in fp32 and bf16, and
   time both (CUDA events, median of 20);
3. drive the full-width GLIP-T + LPI grounding predictor
   (`lpi_tpu_torch.serve.predictor.GroundingPredictor`, `GroundingConfig()`
   defaults, seeded random weights and task keys) through a few requests,
   with the kernels' launch counters checked;
4. run the same model in fp32 on the card and on the CPU (plain versions)
   and compare the head outputs and the inferred task id.

The last lines are the kernels' JSON record, the card's name and power
limit, and `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
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
# 0-3 (stride 2). Six towers.
INPAD_SHAPES = {56: 1, 28: 2, 14: 2, 7: 2, 4: 2}
S2_SHAPES = {56: 1, 28: 1, 14: 1, 7: 1}
TOWERS = 6
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


def bound_ms(h_all: torch.Tensor, oy: torch.Tensor, Cout: int):
    """Least time for the window sum: bytes (h_all, offsets and gate read
    once, out written once) over HBM rate vs fp32 FMAs of 4 corners x K taps
    per output value over the fp32 rate."""
    B, _, Ho, Wo = oy.shape
    nbytes = (h_all.numel() * h_all.element_size() + 3 * oy.numel() * 4
              + B * Ho * Wo * Cout * 4)
    flops = B * Ho * Wo * Cout * K * 4 * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_inputs(gen, side: int, stride: int, dtype, Cout: int = 256):
    """Product map and offsets: uniform in [-m, m], with exact integers and
    the +-m edges mixed in."""
    Ho = (side + stride - 1) // stride
    h = torch.randn(1, side, side, K * Cout, device="cuda", generator=gen).to(dtype)
    oy = (torch.rand(1, K, Ho, Ho, device="cuda", generator=gen) * 2 - 1) * M
    ox = (torch.rand(1, K, Ho, Ho, device="cuda", generator=gen) * 2 - 1) * M
    oy.view(-1)[::7] = torch.round(oy.view(-1)[::7])
    ox.view(-1)[::5] = torch.round(ox.view(-1)[::5])
    oy.view(-1)[::11] = float(M)
    ox.view(-1)[::13] = -float(M)
    gate = torch.rand(1, K, Ho, Ho, device="cuda", generator=gen)
    return h.contiguous(), oy.contiguous(), ox.contiguous(), gate.contiguous()


def check_kernels(dk):
    gen = torch.Generator(device="cuda").manual_seed(0)
    specs = (
        ("window_accumulate_taps_inpad", 1, INPAD_SHAPES, dk.window_accumulate_taps_inpad,
         dk.window_accumulate_taps_inpad_reference, "lpi_tpu/ops/deform_window_kernel.py:534"),
        ("window_accumulate_taps_s2", 2, S2_SHAPES, dk.window_accumulate_taps_s2,
         dk.window_accumulate_taps_s2_reference, "lpi_tpu/ops/deform_window_kernel.py:766"),
    )
    records = {}
    for name, stride, shapes, fn, ref_fn, replaces in specs:
        rec = {"name": name, "route": "cuda",
               "source": "lpi_tpu_torch/csrc/deform_window.cu", "replaces": replaces,
               "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "library_ms": None}
        bound_kinds = set()
        for dtype in (torch.float32, torch.bfloat16):
            for side, per_tower in shapes.items():
                args = kernel_inputs(gen, side, stride, dtype)
                want = ref_fn(*args, M, K, KW)
                got = fn(*args, M, K, KW)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                scale = max(1.0, want.abs().max().item())
                if not (err <= REL_TOL * scale and torch.isfinite(got).all()):
                    raise AssertionError(f"{name} {dtype} side {side}: max abs err "
                                         f"{err} > {REL_TOL} x {scale}")
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                ms = device_time_ms(lambda: fn(*args, M, K, KW), inner=10)
                plain = device_time_ms(lambda: ref_fn(*args, M, K, KW))
                eager = eager_time_ms(lambda: fn(*args, M, K, KW))
                bms, kind = bound_ms(args[0], args[1], 256)
                log(f"kernel {name} {str(dtype)[6:]} in {side}x{side}x{K * 256} "
                    f"stride {stride}: {ms:.6f} ms, plain {plain:.6f} ms, bound "
                    f"{bms:.6f} ms ({kind}), eager call {eager:.6f} ms, max abs "
                    f"err {err:.3e} (tol {REL_TOL} x {scale:.3f})")
                if dtype == torch.bfloat16:  # the 448 px model's product maps
                    n = per_tower * TOWERS
                    rec["ms"] += n * ms
                    rec["plain_ms"] += n * plain
                    rec["bound_ms"] += n * bms
                    bound_kinds.add(kind)
        rec["bound_by"] = "bytes" if bound_kinds == {"bytes"} else "operations"
        records[name] = rec
    return records


def profile_request(predictor, image, caption):
    """One request under torch.profiler: wall time, the device's busy time
    (the sum of its kernels' times), the predictor's phase ranges on the
    host, and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        predictor.predict(image, caption)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile: one request {wall:.3f} ms wall (profiled), device busy "
        f"{busy:.3f} ms ({100 * busy / wall:.1f}%), {sum(e.count for e in kernels)} "
        f"device kernels")
    for e in events:
        if e.is_user_annotation and e.device_type == DeviceType.CPU:
            log(f"profile range {e.key}: {e.cpu_time_total / 1e3:.3f} ms host")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        log(f"profile kernel {e.self_device_time_total / 1e3:.3f} ms x{e.count}: "
            f"{e.key[:100]}")


def assert_close(ours, theirs, what, rel=1e-4, atol=3e-3):
    """The repo's composed-output bar: relative Frobenius error <= rel plus
    an absolute per-element cap."""
    ours = np.asarray(ours, np.float64)
    theirs = np.asarray(theirs, np.float64)
    frob = np.linalg.norm(ours - theirs) / max(np.linalg.norm(theirs), 1e-6)
    worst = np.abs(ours - theirs).max()
    log(f"fp32 card vs cpu {what}: rel frobenius {frob:.3e} (bar {rel}), max abs "
        f"{worst:.3e} (cap {atol})")
    if not (frob <= rel and worst <= atol):
        raise AssertionError(f"{what}: card and cpu disagree")


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

    records = check_kernels(dk)

    # ---- the full-width slice: GLIP-T + LPI at 448 px, bf16 -------------
    cfg = GroundingConfig()
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
                    "window_accumulate_taps_s2": 24 * n_req}:
        raise AssertionError(f"want 54 and 24 launches per forward, got {launches}")
    for name, n in launches.items():
        records[name]["launches"] = n
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

    profile_request(predictor, image, caption)

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

    print(json.dumps({"kernels": list(records.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
