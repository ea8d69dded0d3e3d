"""The `serve_request` driver: one client sends requests back to back (a
closed loop) to the family's `Server`, each a call that returns host arrays,
the requests taken in turn from a set made from the seed.

Set-up builds the server from weights and task keys made on the device from
the seed and sends the first request (which captures its graphs). The
window then sends requests for `--seconds`; each is timed from the call to
its return. `request_ms_p95` is the 95th percentile over every request
completed in the window, `requests_per_s` their count over the window's
seconds. With `--trace 1` a further `traced_requests` requests run under
the profiler.

Correctness, once the window has closed: a sample of the window's requests
drawn from the seed, with the largest image among them, is worked out again
by the reference from the same image and caption, and the program's
answers are held to it by the limits in `workloads/<cell>.json`:

* `task_gap`: how far the reference's distance of the program's task lies
  above its nearest task's, over the nearest's (0 where they agree);
* `box_gap` and `score_gap`: each of the program's top-`TOP` detections
  is matched to the reference's candidate before NMS that it overlaps most
  (the same anchor's box; of candidates whose boxes coincide, as the
  large anchors clipped to the image do, the nearest in score): 1 - the
  least IoU; and the gap between the two scores over the reference's top
  score, its mean over every matched detection of the sample. Matching by anchor and
  not by rank, since the scores of random weights lie so close together
  that a rounding reorders them and NMS keeps another of two overlapping
  boxes;
* `overlap`: how far the largest IoU between two of the program's
  detections passes the configuration's `nms_thresh`, beyond fp32's
  rounding of it (0 as NMS keeps it);
* `count_gap`: the difference in the number of detections.
"""

from __future__ import annotations

import gc
import random
import statistics
import time

import numpy as np
import torch

from benchmark import stats
from benchmark.trace import Profile

TOP = 10
ROUNDING = 1e-5  # the program's IoU is fp32 on boxes in the resized image's coordinates


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: np.clip(x[:, 2:] - x[:, :2], 0, None).prod(-1)  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter, 1e-12)


def compare_one(program: dict, ref: dict, nms_thresh: float) -> dict:
    d = ref["distances"]
    best = float(np.min(d))
    task_gap = (float(d[program["task_id"]]) - best) / max(abs(best), 1e-30)
    boxes = np.asarray(program["boxes"], np.float64).reshape(-1, 4)
    scores = np.asarray(program["scores"], np.float64)
    top = np.argsort(-scores)[:TOP]
    score_gap, box_gap, overlap = np.zeros(0), 0.0, 0.0
    if len(top):
        iou = _iou(boxes[top], np.asarray(ref["cand_boxes"], np.float64))
        best = iou.max(1)
        box_gap = 1.0 - float(best.min())
        # boxes clipped to the image can coincide (the large anchors of the
        # coarse levels): of the candidates that match as well, the nearest
        # score
        cand = np.asarray(ref["cand_scores"], np.float64)[None, :]
        near = np.where(iou >= best[:, None] - 1e-6, np.abs(scores[top, None] - cand), np.inf)
        score_gap = near.min(1) / max(float(np.max(ref["scores"])), 1e-30)
    if len(boxes) > 1:
        same = _iou(boxes, boxes)
        np.fill_diagonal(same, 0.0)
        overlap = max(0.0, float(same.max()) - nms_thresh - ROUNDING)
    return {"task_gap": task_gap, "score_gap": score_gap, "box_gap": box_gap,
            "overlap": overlap, "count_gap": float(abs(len(scores) - len(ref["scores"])))}


def compare(programs: list, refs: list, nms_thresh: float) -> dict:
    """The worst over the requests; `score_gap` the mean over every matched
    detection (one detection's score swings with the rounding of its
    dot product, so its widest gap does not tell bf16 from fp8)."""
    per = [compare_one(p, r, nms_thresh) for p, r in zip(programs, refs)]
    out = {k: max(c[k] for c in per) for k in per[0] if k != "score_gap"}
    out["score_gap"] = float(np.mean(np.concatenate([c["score_gap"] for c in per])))
    return out


def sample(n_done: int, order: list, requests: list, k: int, seed: int) -> list:
    """Positions in the window to check: `k` drawn from the seed, with the
    request of the largest image among them."""
    rng = random.Random(int(seed))
    picks = sorted(rng.sample(range(n_done), min(k, n_done)))
    largest = max(range(n_done), key=lambda i: requests[order[i]][0].size)
    if largest not in picks:
        picks[-1] = largest
    return picks


def run(ctx) -> dict:
    fam, conf, traffic, device = ctx["family"], ctx["conf"], ctx["traffic"], ctx["device"]
    seed, cell = ctx["seed"], ctx["cell_file"]
    with fam.Server.mode():
        weights = fam.make_weights(conf, seed, device)
        keys = fam.make_keys(conf, seed, device)
        reqs = ctx["generator"].requests(traffic, conf, seed, device)
        server = fam.Server(conf, weights, keys, traffic, device)
        del weights
        server.request(*reqs[0])
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - ctx["t0"]

        answers, order, lat = [], [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx["seconds"]:
            i = (len(order) + 1) % len(reqs)
            t = time.perf_counter()
            with torch.profiler.record_function("bench.request"):
                answers.append(server.request(*reqs[i]))
            lat.append((time.perf_counter() - t) * 1e3)
            order.append(i)
        window_s = time.perf_counter() - t0
        tdata, traced = None, 0
        if ctx["trace"]:
            traced = traffic["traced_requests"]
            with Profile() as prof:
                with torch.profiler.record_function("bench.window"):
                    for j in range(traced):
                        with torch.profiler.record_function("bench.request"):
                            server.request(*reqs[(len(order) + 1 + j) % len(reqs)])
            tdata = prof.data
        peak = ctx["memory_peak"]()

    picks = sample(len(order), order, reqs, traffic["checked"], seed)
    del server
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    weights = fam.make_weights(conf, seed, device)
    model = fam.reference_server(conf, weights, keys, device)
    del weights
    flops: list = []
    refs = [fam.reference_request(model, conf, keys, traffic, *reqs[order[i]], device,
                                  flops=flops if (ctx["trace"] and not flops) else None)
            for i in picks]
    checks = compare([answers[i] for i in picks], refs, conf["grounding"]["atss"]["nms_thresh"])
    result = {"attempted": len(order), "peak_bytes": peak, "checks": checks,
              "limits": cell["limits"]}
    if not ctx["trace"]:
        result["metrics"] = {"request_ms_p95": stats.percentile(lat, 95),
                             "requests_per_s": stats.rate(len(order), window_s),
                             "setup_s": setup_s}
        return result
    result["trace"] = tdata
    result["layer_ctx"] = {"kind": "serve", "trace": tdata, "traced_requests": traced,
                           "flops_per_request": flops[0] if flops else None,
                           "peak_bytes": peak, "latency_ms_median": statistics.median(lat)}
    return result
