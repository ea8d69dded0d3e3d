"""`scripts/torch_window_fwd_compare.py` builds kernel sources as they are
and times their forward entries; these pin what it takes from a source and
from the compiler's log, and its cases, on the CPU."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from lpi_tpu_torch.ops import cuda_build

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "scripts" / "torch_window_fwd_compare.py"


def _compare():
    spec = importlib.util.spec_from_file_location("torch_window_fwd_compare", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_kernel_source_has_the_forward_entries():
    compare = _compare()
    compare.check_source((cuda_build.CSRC_DIR / "deform_window.cu").read_text(), "package")
    with pytest.raises(SystemExit, match="no forward entry point lpi_window_padded_fwd"):
        compare.check_source('extern "C" int lpi_window_taps_fwd(void);\n', "old.cu")


def test_it_builds_with_the_package_flags_and_reads_ptxas():
    compare = _compare()
    cmd = compare.nvcc_command("nvcc", "a.cu", "a.so")
    assert cmd == ["nvcc", *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", "a.so", "a.cu"]
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z22window_taps_bwd_kernelIfLi1ELb0ELi4EEv' "
        "for 'sm_90a'",
        "    104 bytes stack frame, 104 bytes spill stores, 104 bytes spill loads",
        "ptxas info    : Used 128 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_Z18window_taps_kernelIfLi2ELb0ELi4EEv' "
        "for 'sm_90a'",
        "ptxas info    : Function properties for _Z18window_taps_kernelIfLi2ELb0ELi4EEv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 72 registers, used 1 barriers, 416 bytes cmem[0]"])
    assert compare.forward_resources(log) == [
        ("_Z18window_taps_kernelIfLi2ELb0ELi4EEv", "72 registers",
         "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")]


def test_it_times_the_levels_chip_smoke_holds():
    compare = _compare()
    assert compare.LEVELS == {1: chip_smoke.INPAD_SHAPES, 2: chip_smoke.S2_SHAPES}
    assert (compare.M, compare.K, compare.KW) == (chip_smoke.M, chip_smoke.K, chip_smoke.KW)


def test_it_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run for real")
    r = subprocess.run([sys.executable, str(SCRIPT)], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 1
    assert r.stdout == ""
