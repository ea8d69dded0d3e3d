"""`scripts/torch_fused_fwd_phases.py` times the phases of the fused forward
kernel from a patched copy of its source; these pin its patches to the
kernel source on the CPU, so that a change of the patched lines shows here
and not first on the card."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from lpi_tpu_torch.ops import cuda_build

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "torch_fused_fwd_phases.py"


def _phases():
    spec = importlib.util.spec_from_file_location("torch_fused_fwd_phases", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_its_patches_apply_to_the_kernel_source_and_only_add_lines():
    phases = _phases()
    src = (cuda_build.CSRC_DIR / "fused_deform.cu").read_text()
    out = phases.instrumented(src)
    kept = iter(out.splitlines())
    assert all(any(line == other for other in kept) for line in src.splitlines())
    assert out.count("clock64()") == 10 and "lpi_fused_phases_clear" in out


def test_a_source_without_the_lines_is_refused():
    with pytest.raises(SystemExit, match="no single line"):
        _phases().instrumented("__global__ void k() {}\n")


def test_it_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run for real")
    r = subprocess.run([sys.executable, str(SCRIPT)], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 1
    assert r.stdout == ""
