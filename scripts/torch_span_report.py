"""The port's own spans over one untraced run of a benchmark cell, on a card.

    python3 scripts/torch_span_report.py --workload CELL --seed N [--seconds 15]

Runs the cell as `python3 -m benchmark.run ... --trace 0` runs it (set-up,
the timed window, the check against the reference) and prints one JSON
line: the run's `setup_s` and whether it was correct; the span totals of
the set-up (`learner.init`, `learner.seed`, `graph.warmup`,
`graph.capture`, and `init_s + capture_s` beside `setup_s`); the untraced
mean of every host span over its newest calls
(`core.profiling.span_recent_ms`: the window's last steps or requests,
with `graph.replay` beside `train.step`, `predict.wait` and
`predict.postprocess`); and the device spans of the last step or request.
No profiler runs, so no number carries its cost. Run each seed in a
process of its own: the tables are the process's. Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from benchmark import run as bench_run  # noqa: E402  (starts the set-up's clock)

SETUP = ("learner.init", "learner.seed", "graph.warmup", "graph.capture")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 scripts/torch_span_report.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    a = ap.parse_args(argv)
    bench_run.cache_dirs()
    import torch

    from lpi_tpu_torch.core import profiling

    if not torch.cuda.is_available():
        print("torch_span_report: needs a CUDA card", file=sys.stderr)
        return 1
    args = argparse.Namespace(workload=a.workload, seed=a.seed, seconds=a.seconds, trace=0)
    result = bench_run.run_cell(args, "cuda")
    totals = profiling.span_totals()
    setup = {k: totals[k][0] for k in SETUP if k in totals}
    init_capture = sum(setup.get(k, 0.0) for k in ("learner.init", "graph.warmup",
                                                   "graph.capture"))
    print(json.dumps({
        "workload": a.workload, "seed": a.seed, "correct": result["correct"],
        "setup_s": result["metrics"]["setup_s"]["value"],
        "setup_spans_s": setup, "init_plus_capture_s": init_capture,
        "recent_ms": profiling.span_recent_ms(), "device_ms": profiling.device_span_ms(),
        "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
