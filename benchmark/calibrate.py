"""The readings that the limits of a cell are set from, on the card at the
cell's own size, in one process:

    python3 -m benchmark.calibrate --workload CELL --seeds 1 2 3 ... [--control 3]

For every seed: the program's three checked steps (the cell's driver's
set-up: weights and batches from the seed, the captured step) held to the
fp32 reference, as a run holds them (`drivers/train_step.py:compare`).
For the first `--control` seeds also:

* the control: the reference computed with every product in fp8
  (`reference/layers.py:lower_precision`), in the program's place;
* the fault "half of the batch left out": the reference on the first half
  of each batch, the mean over it, in the program's place;
* a witness for the program's own precision: the reference computed in
  the configuration's dtype (bf16), in the program's place.

(A step that leaves its state unchanged reads 1 by the change's measure
and needs no run.) For a serving cell: the program's answers to the
`checked` first requests of the seed's set (the largest image among them)
held to the reference as a run holds them (`drivers/serve_request.py`),
and for the first `--control` seeds the control and the reference in the
configuration's dtype in the program's place. One JSON line per reading
on standard output, with the per-leaf norms of a training cell.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from benchmark.drivers.train_step import CHECKED, compare, leaves
from benchmark.manifest import Manifest


def half(batches):
    return [{k: v[: len(v) // 2] for k, v in b.items()} for b in batches]


def serve_readings(manifest, cell: dict, seed: int, device, program: bool,
                   control: bool) -> list:
    """-> [(what, checks, {})] for one seed of a serving cell."""
    from benchmark.drivers import serve_request as drv

    conf, traffic = cell["conf"], cell["traffic_params"]
    fam = manifest.family(conf["family"])
    reqs = manifest.generator(traffic["generator"]).requests(traffic, conf, seed, device)
    n = min(traffic["checked"], len(reqs))
    largest = max(range(len(reqs)), key=lambda i: reqs[i][0].size)
    picks = list(range(n - 1)) + [largest if largest >= n - 1 else n - 1]
    keys = fam.make_keys(conf, seed, device)
    out = []
    if program:
        server = fam.Server(conf, fam.make_weights(conf, seed, device), keys, traffic, device)
        answers = [server.request(*reqs[i]) for i in picks]
        del server
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    weights = fam.make_weights(conf, seed, device)
    model = fam.reference_server(conf, weights, keys, device)
    refs = [fam.reference_request(model, conf, keys, traffic, *reqs[i], device) for i in picks]
    if program:
        out.append(("program", drv.compare(answers, refs, _nms(conf)), {}))
    if control:
        other = [fam.reference_request(model, conf, keys, traffic, *reqs[i], device, lower=True)
                 for i in picks]
        out.append(("control_fp8", drv.compare(_as_answers(other), refs, _nms(conf)), {}))
        dtype = conf["grounding"]["dtype"]
        low = fam.reference_server(conf, weights, keys, device, dtype)
        other = [fam.reference_request(low, conf, keys, traffic, *reqs[i], device)
                 for i in picks]
        out.append(("reference_" + dtype, drv.compare(_as_answers(other), refs, _nms(conf)), {}))
    return out


def _as_answers(refs: list) -> list:
    return [{"task_id": r["task"], "boxes": r["boxes"], "scores": r["scores"]} for r in refs]


def _nms(conf: dict) -> float:
    return conf["grounding"]["atss"]["nms_thresh"]


def readings(manifest, cell_name: str, seed: int, device, program: bool, control: bool,
             cell=None) -> list:
    """-> [(what, checks, leaves)] for one seed."""
    cell = cell or manifest.cell(cell_name)
    if cell["cell_file"]["driver"] == "serve_request":
        return serve_readings(manifest, cell, seed, device, program, control)
    conf, traffic = cell["conf"], cell["traffic_params"]
    fam = manifest.family(conf["family"])
    gen = manifest.generator(traffic["generator"])
    batches = gen.batches(traffic, conf, seed, device)[:CHECKED]
    out = []
    weights = fam.make_weights(conf, seed, device)
    task = traffic["task"]
    if program:
        with fam.Trainer.mode():
            trainer = fam.Trainer(conf, weights, traffic, device)
            losses = []
            for i in range(CHECKED):
                res = trainer.step(batches[i])
                losses.append({k: v.detach().clone() for k, v in trainer.terms(res).items()})
                if i == 0:
                    grads = trainer.first_grads()
            prog = {"losses": [{k: float(v) for k, v in t.items()} for t in losses],
                    "grads": grads,
                    "params": {n: p[task].detach().clone() for n, p in trainer.pools.items()}}
        del trainer
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        weights = fam.make_weights(conf, seed, device)
    record: list = []
    ref = fam.reference_steps(conf, weights, batches, task, CHECKED, device, record=record)
    start = {n: weights[n][task] for n in ref["params"]}
    if record:
        m = conf["grounding"]["dyhead"]["deform_window"]
        edge = sum(float(((oy.abs() == m) | (ox.abs() == m)).float().sum())
                   for oy, ox, *_ in record)
        out.append(("offsets", {"share_at_clamp": edge / sum(r[0].numel() for r in record)}, {}))
    if program:
        out.append(("program", compare(prog, ref, start), leaves(prog, ref, start)))
    if control:
        dtype = conf.get("grounding", conf.get("retrieval"))["dtype"]
        for what, kw in (("control_fp8", {"lower": True}), ("fault_half_batch", {}),
                         ("reference_" + dtype, {"dtype": dtype})):
            bs = half(batches) if what == "fault_half_batch" else batches
            other = fam.reference_steps(conf, weights, bs, task, CHECKED, device, **kw)
            out.append((what, compare(other, ref, start), leaves(other, ref, start)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 1
    manifest = Manifest()
    cell = manifest.cell(args.workload)
    for i, seed in enumerate(args.seeds):
        for what, checks, per_leaf in readings(manifest, args.workload, seed, "cuda", True,
                                               i < args.control, cell):
            print(json.dumps({"workload": args.workload, "seed": seed, "what": what,
                              "checks": checks, "leaves": per_leaf}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
