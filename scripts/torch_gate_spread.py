"""Run-to-run spread of the port's grounding quality gate on one card.

    python3 scripts/torch_gate_spread.py [--runs 4] [--routes pallas,fused]
                                         [--deterministic]

Starts `runs` runs of `lpi_tpu_torch.bench.bench_quality_grounding` per
route as child processes, all at once on the one card (the runs are host-
bound, so they share the card and the cores), and prints each run's result
and, per route, the least and the mean of each metric. The recipe and the
weights are the same in every run of a route; what differs between runs is
only the order of the card's floating-point sums. Without
`--deterministic` the runs take the card's default algorithms (atomics in
several backward passes); with it they run as the gate does, under
`lpi_tpu_torch.bench.deterministic`, to see that the runs then repeat.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
_CHILD = """
import json, sys, time
from lpi_tpu_torch import bench
t = time.perf_counter()
run = bench.bench_quality_grounding if sys.argv[2] == "1" else bench._gate_run
out = run(device="cuda", deform_impl=sys.argv[1], pretrain_steps=242, epochs=8, n_tasks=3)
out["seconds"] = time.perf_counter() - t
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--routes", default="pallas,fused")
    ap.add_argument("--deterministic", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_gate_spread: no CUDA device", file=sys.stderr)
        return 1
    from lpi_tpu_torch.ops import cuda_build

    cuda_build.build()  # once, before the children load the libraries
    env = dict(os.environ, PYTHONPATH=REPO)
    if args.deterministic:  # before the children's first cuBLAS call
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    flag = str(int(args.deterministic))
    procs = [(route, subprocess.Popen([sys.executable, "-c", _CHILD, route, flag], cwd=REPO,
                                      env=env, stdout=subprocess.PIPE, text=True))
             for route in args.routes.split(",") for _ in range(args.runs)]
    t = time.perf_counter()
    results = {}
    failed = 0
    for route, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed += 1
            continue
        results.setdefault(route, []).append(json.loads(out.strip().splitlines()[-1]))
    print(f"{len(procs)} runs at once (deterministic: {args.deterministic}) in "
          f"{time.perf_counter() - t:.3f} s on {torch.cuda.get_device_name(0)}")
    for route, runs in results.items():
        for r in runs:
            print(f"gate {route}: {json.dumps(r)}")
        for key in ("grounding_p1", "grounding_p5", "grounding_task_id_acc",
                    "grounding_forgetting"):
            vals = [r[key] for r in runs]
            print(f"gate {route} {key}: min {min(vals)}, max {max(vals)}, "
                  f"mean {sum(vals) / len(vals):.4f} over {len(vals)} runs")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
