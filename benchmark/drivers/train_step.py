"""The `train_step` driver: one continual session's captured train step,
fed host batches in turn from a ring, as a session's loop feeds them.

Set-up builds the family's `Trainer` from weights made on the device from
the seed, and drives it through its first three steps (the first captures
the step), through the window's own call, on distinct batches. The window
then calls the step back to back for `--seconds`, waiting only on the step
`LAG` calls back, so the host is never more than `LAG` steps ahead of the
card, and ends after a synchronise. `train_samples_per_s` is every sample
of every step in the window over the window's seconds.

With `--trace 1` a further `traced_steps` steps run under the profiler
(`trace.py`) after the window; the per-layer metrics read them.

Correctness, once the window has closed and the peak memory has been read:
the frozen weights (after the window) and the other tasks' pool rows
(after the checked steps) must be bit-equal to the weights made from the
seed again; the trainer is freed; the reference
(`families/<family>.py`) follows the first three steps from those weights
on the same batches, and the program's three losses, its first gradient
(from the optimizer's state after one step) and its parameters' change
after three steps are held to it by the limits in `workloads/<cell>.json`.
"""

from __future__ import annotations

import collections
import gc
import statistics
import time
from typing import Dict

import torch

from benchmark import stats
from benchmark.trace import Profile

LAG = 2  # steps the host may run ahead of the card
CHECKED = 3  # steps the reference follows
SMALL = 1e-3  # a leaf whose reference gradient is under this share of the median leaf's


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _steps(trainer, batches, first: int, seconds: float, device, calls: list,
           limit: int = 0) -> int:
    """Call the step on batches[first], [first + 1], ... until `seconds`
    have passed (or `limit` calls); -> the calls made. Each call's host
    time goes to `calls` (ms)."""
    cuda = torch.device(device).type == "cuda"
    pending = collections.deque()
    n = 0
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        with torch.profiler.record_function("bench.step"):
            trainer.step(batches[(first + n) % len(batches)])
        calls.append((time.perf_counter() - t) * 1e3)
        n += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > LAG:
                with torch.profiler.record_function("bench.wait"):
                    pending.popleft().synchronize()
        if (limit and n >= limit) or (not limit and time.perf_counter() - t0 >= seconds):
            return n


def run(ctx) -> dict:
    fam, conf, traffic, device = ctx["family"], ctx["conf"], ctx["traffic"], ctx["device"]
    seed, cell = ctx["seed"], ctx["cell_file"]
    with fam.Trainer.mode():
        weights = fam.make_weights(conf, seed, device)
        batches = ctx["generator"].batches(traffic, conf, seed, device)
        trainer = fam.Trainer(conf, weights, traffic, device)
        del weights
        task = trainer.task
        losses, grads = [], None
        for i in range(CHECKED):
            out = trainer.step(batches[i])
            losses.append({k: v.detach().clone() for k, v in trainer.terms(out).items()})
            if i == 0:
                grads = trainer.first_grads()
        rows = {n: p.detach().clone() for n, p in trainer.pools.items()}
        _sync(device)
        setup_s = time.perf_counter() - ctx["t0"]

        calls: list = []
        t0 = time.perf_counter()
        steps = _steps(trainer, batches, CHECKED, ctx["seconds"], device, calls)
        _sync(device)
        window_s = time.perf_counter() - t0
        tdata, traced = None, 0
        if ctx["trace"]:
            traced = traffic["traced_steps"]
            with Profile() as prof:
                with torch.profiler.record_function("bench.window"):
                    _steps(trainer, batches, CHECKED + steps, 0.0, device, [], limit=traced)
                    _sync(device)
            tdata = prof.data
        peak = ctx["memory_peak"]()

    # ---- correctness, after the window ------------------------------------
    program = {"losses": [{k: float(v) for k, v in t.items()} for t in losses],
               "grads": grads, "params": {n: p[task] for n, p in rows.items()}}
    made = fam.make_weights(conf, seed, device)
    with torch.no_grad():
        frozen_moved = sum(int((trainer.frozen[n] != made[n]).sum()) for n in trainer.frozen)
        rows_moved = 0
        for n, p in rows.items():
            keep = torch.arange(p.shape[0], device=p.device) != task
            rows_moved += int((p[keep] != made[n][keep]).sum())
    del trainer, out
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    record, flops = [], []
    ref = fam.reference_steps(conf, made, batches[:CHECKED], task, CHECKED, device,
                              record=record if ctx["trace"] else None,
                              flops=flops if ctx["trace"] else None)
    start = {n: made[n][task] for n in ref["params"]}
    checks = compare(program, ref, start)
    checks["frozen_moved"] = float(frozen_moved)
    checks["other_rows_moved"] = float(rows_moved)

    result = {"attempted": CHECKED + steps, "peak_bytes": peak, "checks": checks,
              "limits": cell["limits"]}
    if not ctx["trace"]:
        result["metrics"] = {
            "train_samples_per_s": stats.rate(steps * traffic["batch"], window_s),
            "setup_s": setup_s}
        return result
    result["trace"] = tdata
    result["layer_ctx"] = {
        "kind": "train", "trace": tdata, "traced_steps": traced,
        "host_call_ms": statistics.fmean(calls),
        "flops_per_step": fam.step_flops(conf, traffic, flops[0] if flops else None),
        "window_bound_s": fam.window_bound_s(conf, record), "peak_bytes": peak}
    return result


def compare(program: dict, ref: dict, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers the limits hold, each the worst over its parts:

    * `loss_gap`: over the checked steps and each loss term and their total,
      |program - reference| / the larger of |reference| and a hundredth of
      the reference's total;
    * `grad_gap`: per pool leaf, the gap between the norms of the first
      gradient (the task's row), over the larger of the reference's norm and
      the median leaf's;
    * `change_gap`: the same for the norm of each leaf's change over the
      checked steps, leaves whose reference gradient is under `SMALL` of
      the median leaf's left out (they move by round-off alone)."""
    loss_gap = max(abs(p[k] - r[k]) / max(abs(r[k]), 0.01 * abs(r["total"]), 1e-30)
                   for p, r in zip(program["losses"], ref["losses"]) for k in r)
    names = list(ref["grads"])
    g_ref = {n: float(ref["grads"][n].norm()) for n in names}
    g_prog = {n: float(program["grads"][n].float().norm()) for n in names}
    g_med = statistics.median(g_ref.values())
    grad_gap = max(stats.norm_gap(g_prog[n], g_ref[n], g_med) for n in names)
    moved = [n for n in names if g_ref[n] >= SMALL * g_med]
    d_ref = {n: float((ref["params"][n] - start[n]).norm()) for n in moved}
    d_prog = {n: float((program["params"][n].float() - start[n]).norm()) for n in moved}
    d_med = statistics.median(d_ref.values())
    change_gap = max(stats.norm_gap(d_prog[n], d_ref[n], d_med) for n in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


def leaves(program: dict, ref: dict, start: Dict[str, torch.Tensor]) -> Dict[str, list]:
    """Per pool leaf: [program's first-gradient norm, reference's, program's
    change norm, reference's], for the record beside `compare`."""
    return {n: [float(program["grads"][n].float().norm()), float(ref["grads"][n].norm()),
                float((program["params"][n].float() - start[n]).norm()),
                float((ref["params"][n] - start[n]).norm())] for n in ref["grads"]}
