"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload CELL --seed N --seconds S --trace 0|1

The cell's driver (`drivers/<driver>.py`) sets the program up from the seed,
measures for S seconds, and checks what the timed path produced against
the plain reference. With `--trace 0` the result's metrics are the cell's
end-to-end metrics; with `--trace 1`, its per-layer metrics, each read by
`metrics/<name>.py` from the traced sub-window. The last line on standard
output is one JSON object; the numbers compared, each beside its limit,
end standard error and the result line (`checks`).

Exits 1 without a CUDA device (or with fewer than the cell asks for), and
4 if a JAX module was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "lpi_tpu")


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    checkout's first run builds (the port's own `nvcc` builds go to
    `build/lpi_tpu_torch/` there already)."""
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(args, device, manifest=None, t0: float = T0) -> dict:
    """Run the cell on `device` and return the result line's object (the
    look for a card is the caller's)."""
    import torch

    from benchmark.manifest import Manifest

    manifest = manifest or Manifest()
    cell = manifest.cell(args.workload)
    conf = cell["conf"]
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def memory_peak() -> int:
        return int(torch.cuda.max_memory_allocated()) if cuda else 0

    ctx = {"family": manifest.family(conf["family"]), "conf": conf,
           "traffic": cell["traffic_params"], "cell_file": cell["cell_file"],
           "device": device, "seed": args.seed, "seconds": args.seconds,
           "trace": bool(args.trace), "t0": t0, "memory_peak": memory_peak,
           "generator": manifest.generator(cell["traffic_params"]["generator"])}
    out = manifest.driver(cell["cell_file"]["driver"]).run(ctx)
    missing = set(out["limits"]) - set(out["checks"])
    if missing:
        raise KeyError(f"the cell's limits name numbers the driver does not read: {missing}")
    checks = {k: {"value": out["checks"][k], "limit": limit}
              for k, limit in out["limits"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    failed = sum(1 for c in checks.values()
                 if not (math.isfinite(c["value"]) and c["value"] <= c["limit"]))
    result = {"correct": correct, "attempted": out["attempted"], "failed": failed}
    if args.trace:
        result["metrics"] = {}
        for m in manifest.per_layer(args.workload):
            value = manifest.metric(m["name"]).read(out["layer_ctx"])
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        result["metrics"] = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]}
                             for m in manifest.end_to_end(args.workload)}
    result["device"] = {"platform": "gpu" if cuda else "cpu",
                        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                        "count": 1, "memory_peak_bytes": out["peak_bytes"]}
    if args.trace:
        result["device"]["busy_s"] = out["trace"].busy_s()
        result["device"]["window_s"] = out["trace"].window_s()
        result["breakdown"] = out["trace"].breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs()
    import torch

    from benchmark.manifest import Manifest

    manifest = Manifest()
    chips = manifest.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 1
    result = run_cell(args, "cuda", manifest)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules loaded that the benchmark refuses: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
