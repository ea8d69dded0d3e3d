"""On a CUDA card: one short run of the retrieval cell at its published
widths, correct, with its metrics and device. Skips without a card (decided
inside the test). On the card: `python -m pytest -m gpu benchmark/tests`."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.gpu
def test_a_short_run_of_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "retr-train-b64",
                        "--seed", "4100000001", "--seconds", "2", "--trace", "0"], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert out["metrics"]["train_samples_per_s"]["value"] > 0
