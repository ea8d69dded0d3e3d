"""The plain reference against the port at toy widths, both in fp32, where
they compute the same function: the training steps' losses, first
gradients and changes, and the request's task, scores and boxes."""

import pytest

from benchmark import calibrate
from benchmark.tests import tiny

FP32 = 1e-4  # two fp32 computations of one function, in other orders


@pytest.mark.parametrize("cell", ["ground-train-b16", "retr-train-b64", "ground-serve-b1"])
def test_reference_follows_the_program_in_fp32(cell):
    m = tiny.manifest("float32")
    (what, checks, _), = [r for r in calibrate.readings(m, cell, 17, "cpu", True, False,
                                                        cell=m.cell(cell))
                          if r[0] == "program"]
    assert checks and all(v <= FP32 for v in checks.values()), checks
