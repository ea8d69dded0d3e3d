"""`scripts/torch_fused_compare.py` builds fused-conv kernel sources as they
are, and patched copies that run one half of the backward's sample launch;
these pin its build command, its reading of the compiler's log, its levels
and its patches to the kernel source's launch lines, on the CPU, so that a
change of those lines shows here and not first on the card."""

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
SCRIPT = ROOT / "scripts" / "torch_fused_compare.py"


def _compare():
    spec = importlib.util.spec_from_file_location("torch_fused_compare", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_kernel_source_has_the_entries():
    compare = _compare()
    compare.check_source((cuda_build.CSRC_DIR / "fused_deform.cu").read_text(), "package")
    with pytest.raises(SystemExit, match="no entry point lpi_fused_deform_bwd"):
        compare.check_source('extern "C" int lpi_fused_deform_fwd(void);\n', "old.cu")


def test_it_builds_with_the_package_flags_and_reads_ptxas():
    compare = _compare()
    assert compare.nvcc_command("nvcc", "a.cu", "a.so") == [
        "nvcc", *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", "a.so", "a.cu"]
    assert compare.nvcc_command("nvcc", "a.cu", "a.so", verbose=False) == [
        "nvcc", *cuda_build.NVCC_FLAGS, "-o", "a.so", "a.cu"]
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z22window_taps_bwd_kernelIfLi1ELb0ELi4EEv' "
        "for 'sm_90a'",
        "ptxas info    : Used 128 registers, used 0 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_116fused_fwd_kernelILi4ELi8ELi4EEEvPKfS2_' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_116fused_fwd_kernelILi4ELi8ELi4EEEv",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 126 registers, used 1 barriers, 416 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113dw_sum_kernelEPKfPfxi' "
        "for 'sm_90a'",
        "ptxas info    : Used 12 registers, used 0 barriers, 380 bytes cmem[0]"])
    assert compare.kernel_resources(log) == [
        ("_ZN12_GLOBAL__N_116fused_fwd_kernelILi4ELi8ELi4EEEvPKfS2_", "126 registers",
         "8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads"),
        ("_ZN12_GLOBAL__N_113dw_sum_kernelEPKfPfxi", "12 registers", "")]


def test_its_patches_change_one_launch_line_each():
    src = (cuda_build.CSRC_DIR / "fused_deform.cu").read_text()
    variants = _compare().patched(src)
    assert set(variants) == {"full", "df", "offsets"} and variants["full"] == src
    assert "const long long off_blocks = 0 * (" in variants["df"]
    assert "const long long df_blocks = 0 * (" in variants["offsets"]
    for name in ("df", "offsets"):
        changed = [a for a, b in zip(src.splitlines(), variants[name].splitlines()) if a != b]
        assert len(changed) == 1 and len(src.splitlines()) == len(variants[name].splitlines())


def test_a_source_of_no_known_form_is_refused():
    with pytest.raises(SystemExit, match="no known launch form"):
        _compare().patched("__global__ void k() {}\n")


def test_it_times_the_levels_chip_smoke_holds():
    compare = _compare()
    assert compare.LEVELS == {1: chip_smoke.INPAD_SHAPES, 2: chip_smoke.S2_SHAPES}
    assert (compare.M, compare.K, compare.KW) == (chip_smoke.M, chip_smoke.K, chip_smoke.KW)
    assert compare.BATCHES == (chip_smoke.PREDICT_BATCH, chip_smoke.TRAIN_BATCH)
    assert compare.C == 256


def test_it_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run for real")
    r = subprocess.run([sys.executable, str(SCRIPT)], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 1
    assert r.stdout == ""
