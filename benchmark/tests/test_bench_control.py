"""The correctness check fails what it must, at toy widths:

* the control (the reference with every product in fp8, in the program's
  place) reads at least three times what the program (bf16) reads in one of
  the cell's numbers, and fails the cell's limits;
* a whole run with the timed path broken underneath comes out not correct,
  for each fault the cell can have: a training step that leaves its state
  unchanged, or that leaves out half of its batch (the mean over the rest);
  a request whose answer is altered where it is produced (its boxes, its
  scores, its task). The sound run, in fp32 at these widths, is correct.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import calibrate
from benchmark.tests import tiny

LIMITS = {p.stem: json.loads(p.read_text())["limits"]
          for p in (Path(__file__).resolve().parents[1] / "workloads").glob("*.json")}


@pytest.mark.parametrize("cell", sorted(LIMITS))
def test_the_control_fails_and_separates_from_the_program(cell):
    m = tiny.manifest()
    got = {what: checks for what, checks, _ in
           calibrate.readings(m, cell, 23, "cpu", True, True, cell=m.cell(cell))}
    prog, ctrl = got["program"], got["control_fp8"]
    assert any(ctrl[k] >= 3 * prog[k] and ctrl[k] > 0 for k in LIMITS[cell]), (prog, ctrl)
    assert any(ctrl[k] > lim for k, lim in LIMITS[cell].items()), ctrl


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if hasattr(obj, "__dict__"):
        return [t for o in vars(obj).values() for t in _tensors(o)]
    return []


def _broken(fault):
    """A manifest whose family's program carries `fault`."""
    base = tiny.manifest("float32")

    class Broken(type(base)):
        def family(self, name):
            fam = super().family(name)
            Trainer, Server = fam.Trainer, getattr(fam, "Server", None)

            class T(Trainer):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    step = self.step
                    state = list(self.pools.values()) + _tensors(self.learner._session)

                    def unchanged(batch):
                        saved = [t.detach().clone() for t in state]
                        out = step(batch)
                        with torch.no_grad():
                            for t, s in zip(state, saved):
                                t.copy_(s)
                        return out

                    def half(batch):
                        return step({k: v[: len(v) // 2] for k, v in batch.items()})

                    self.step = {"unchanged": unchanged, "half_batch": half}.get(fault, step)

            class S(Server or object):
                def request(self, image, caption):
                    out = dict(super().request(image, caption))
                    if fault == "boxes":
                        out["boxes"] = out["boxes"] + 8.0
                    elif fault == "scores":
                        out["scores"] = out["scores"] * 1.05
                    elif fault == "task":
                        out["task_id"] = (out["task_id"] + 1) % 12
                    return out

            fam.Trainer = T
            if Server is not None:
                fam.Server = S
            return fam

    return Broken()


@pytest.mark.parametrize("cell,fault", [
    ("ground-train-b16", None), ("ground-train-b16", "unchanged"),
    ("ground-train-b16", "half_batch"), ("retr-train-b64", None),
    ("retr-train-b64", "unchanged"), ("retr-train-b64", "half_batch"),
    ("ground-serve-b1", None), ("ground-serve-b1", "boxes"), ("ground-serve-b1", "scores"),
    ("ground-serve-b1", "task")])
def test_a_broken_timed_path_comes_out_not_correct(cell, fault):
    out = tiny.run(cell, _broken(fault))
    assert out["correct"] is (fault is None), out["checks"]
    assert np.isfinite([c["value"] for c in out["checks"].values()]).all()
