"""`scripts/torch_window_bwd_split.py` patches the deform-window backward's
launch to time its two halves alone; these pin its patches to the kernel
source, so that a change of the launch lines shows here, on the CPU, and
not first on the card."""

import importlib.util
from pathlib import Path

import pytest
import torch

from lpi_tpu_torch.ops import cuda_build

torch.set_num_threads(1)

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "torch_window_bwd_split.py"


def _split():
    spec = importlib.util.spec_from_file_location("torch_window_bwd_split", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_kernel_source_matches_a_known_launch_form():
    split = _split()
    src = (cuda_build.CSRC_DIR / "deform_window.cu").read_text()
    form, variants = split.patched(src)
    assert form == "d h strips + warp per (pixel, tap)"
    assert set(variants) == {"full", "dh", "offsets"} and variants["full"] == src
    assert "long long off_blocks = 0 * (" in variants["dh"]
    assert "long long dh_blocks = 0 * (" in variants["offsets"]
    for name in ("dh", "offsets"):  # one line changed, nothing else
        changed = [a for a, b in zip(src.splitlines(), variants[name].splitlines()) if a != b]
        assert len(changed) == 1 and len(src.splitlines()) == len(variants[name].splitlines())


def test_a_source_of_no_known_form_is_refused():
    with pytest.raises(SystemExit, match="no known launch form"):
        _split().patched("__global__ void k() {}\n")
