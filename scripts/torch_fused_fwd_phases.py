"""Split the fused forward kernel's time into its phases, inside the kernel.

    python scripts/torch_fused_fwd_phases.py [SOURCE.cu]

Needs a CUDA card and `nvcc` for sm_90a. The script patches a copy of the
fused conv's source (default: the package's own
`lpi_tpu_torch/csrc/fused_deform.cu`) with `clock64()` reads around the
phases of `fused_fwd_kernel`, as thread 0 of each block sees them, and a
`%globaltimer` read at its start and end; the patches are plain text
replacements of known lines, and a source that lacks one is refused. It
builds the copy under `build/fused_fwd_phases/`, runs the forward at the
stride-1 levels of the 448 px head (batch 4, and P3 at batch 1; 256
channels, inputs as `chip_smoke.fused_inputs` makes them), and prints, per
level, the blocks' mean cycles in each phase: the prologue (the first W
chunks and the tile's offsets), the corner tables (with the barriers
around them), the slab sampling, the wait and barrier before a chunk, the
issue of the next chunk's copies, and the product, beside the SM clock that
the two timers give. The instrumented kernel runs slower than the kernel
itself; the shares, not the times, are what it measures.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import fused_inputs  # noqa: E402
from lpi_tpu_torch.ops import cuda_build  # noqa: E402
from lpi_tpu_torch.profile_deform import card_line  # noqa: E402

OUT = ROOT / "build" / "fused_fwd_phases"
CASES = ((4, 4), (7, 4), (14, 4), (28, 4), (56, 4), (56, 1))  # (side, batch), stride 1
PHASES = ("prologue", "tables", "sampling", "wait+barrier", "issue", "product")
MAX_BLOCKS = 65536

EPILOGUE = ("#pragma unroll\n  for (int i = 0; i < RP; ++i) {\n"
            "    const long long p = p0 + RP * ty + i;\n    if (p >= npix) continue;\n")
WAIT = ("    copy_wait<NST - 2>();\n"
        "    __syncthreads();  // chunk t (and the slab) visible; chunk t - 1 no longer read\n"
        "    issue(t + NST - 1);\n")
LOOP = ("  for (int t = 0; t < T; ++t) {\n    const int k = t / nch, j = t % nch;\n"
        "    if (j % cps == 0) {\n")
START = "  const int T = K * nch;\n  const long long plane = (long long)Ho * Wo;\n"
# (old, new): plain text replacements in the forward kernel; every `old`
# must occur once in the source
PATCHES = [
    ("namespace {\n",
     "namespace {\n"
     "__device__ unsigned long long g_phase[65536][8];\n"
     "__device__ __forceinline__ unsigned long long phase_timer() {\n"
     "  unsigned long long t;\n"
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
     "  return t;\n"
     "}\n"),
    (START, START +
     "  const long long c_start = clock64();\n"
     "  const unsigned long long g_start = phase_timer();\n"
     "  long long c_loop = 0, c_table = 0, c_sample = 0, c_wait = 0, c_issue = 0;\n"
     "  long long c_comp = 0;\n"
     "  long long ca = 0, cb = 0, cd = 0, ce = 0, cf = 0;\n"),
    (LOOP,
     "  for (int t = 0; t < T; ++t) {\n    const int k = t / nch, j = t % nch;\n"
     "    if (t == 0) c_loop = clock64();\n"
     "    if (t > 0) c_comp += clock64() - cf;\n"
     "    if (j % cps == 0) {\n      ca = clock64();\n"),
    ("      const int cs0 = j * TC;\n",
     "      cb = clock64();\n      c_table += cb - ca;\n      const int cs0 = j * TC;\n"),
    (WAIT,
     "    cd = clock64();\n    if (j % cps == 0) c_sample += cd - cb;\n" + WAIT.replace(
         "    issue(t + NST - 1);\n",
         "    ce = clock64();\n    c_wait += ce - cd;\n    issue(t + NST - 1);\n"
         "    cf = clock64();\n    c_issue += cf - ce;\n")),
    (EPILOGUE,
     "  c_comp += clock64() - cf;\n"
     "  if (tid == 0 && blockIdx.y == 0 && blockIdx.x < 65536) {\n"
     "    unsigned long long* r = g_phase[blockIdx.x];\n"
     "    r[0] = clock64() - c_start; r[1] = phase_timer() - g_start;\n"
     "    r[2] = c_loop - c_start;\n"
     "    r[3] = c_table; r[4] = c_sample; r[5] = c_wait; r[6] = c_issue; r[7] = c_comp;\n"
     "  }\n" + EPILOGUE),
]
READER = """
extern "C" int lpi_fused_phases(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(unsigned long long) * 8 * n);
}

extern "C" int lpi_fused_phases_clear() {
  void* p = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&p, g_phase);
  return (int)(err != cudaSuccess ? err : cudaMemset(p, 0, sizeof(g_phase)));
}
"""


def instrumented(src: str) -> str:
    """The source with the phase timers; SystemExit where a patched line is
    missing or not unique."""
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"the source has no single line {old!r}")
        src = src.replace(old, new)
    return src + READER


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fused_fwd_phases: no CUDA device", file=sys.stderr)
        return 1
    source = Path(sys.argv[1] if len(sys.argv) > 1 else cuda_build.CSRC_DIR / "fused_deform.cu")
    card = card_line()
    print(f"card: {card}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / "fused_phases.cu", OUT / "fused_phases.so"
    cu.write_text(instrumented(source.read_text()))
    r = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    so = ctypes.CDLL(str(lib))
    fwd, read, clear = so.lpi_fused_deform_fwd, so.lpi_fused_phases, so.lpi_fused_phases_clear
    fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    gen = torch.Generator(device="cuda").manual_seed(0)
    for side, batch in CASES:
        f, oy, ox, g, w, _ = fused_inputs(gen, side, 1, batch, 256)
        B, H, W, C = f.shape
        out = torch.empty(B, H, W, 256, device="cuda")
        for i in range(3):  # the third call's timers are read
            if i == 2 and (torch.cuda.synchronize() or clear()):
                raise RuntimeError("clearing the timers failed")
            err = fwd(f.data_ptr(), oy.data_ptr(), ox.data_ptr(), g.data_ptr(), w.data_ptr(),
                      out.data_ptr(), B, H, W, C, H, W, 9, 3, 256, 3, 1,
                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        torch.cuda.synchronize()
        blocks = min(MAX_BLOCKS, B * H * W)
        buf = np.zeros((blocks, 8), np.uint64)
        if read(buf.ctypes.data, blocks):
            raise RuntimeError("reading the timers failed")
        rows = buf[buf[:, 0] > 0].astype(np.float64)
        mean = rows.mean(0)
        shares = ", ".join(f"{n} {v:.0f} ({100 * v / mean[0]:.1f}%)"
                           for n, v in zip(PHASES, mean[2:]))
        print(f"forward b{batch} in {side}x{side}x256, {len(rows)} blocks of the first column "
              f"tile: {mean[0]:.0f} cycles a block ({mean[1] / 1e3:.2f} us, SM clock "
              f"{mean[0] / mean[1]:.3f} GHz): {shares}", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
