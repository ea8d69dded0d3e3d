"""Split the deform-window backward kernel's time into its two halves.

    python scripts/torch_window_bwd_split.py [SOURCE.cu ...]

Needs a CUDA card and `nvcc` for sm_90a. The backward launch of
`lpi_tpu_torch/csrc/deform_window.cu` (`lpi_window_taps_bwd`) runs two kinds
of blocks: those that write d h_all and those that write d oy, d ox and
d gate. For each source given (default: the package's own), this script
builds three libraries from patched copies of it under
`build/window_bwd_split/`: the launch as it is, the d h blocks alone and the
offset-gradient blocks alone. The patches are plain text replacements of the
launch lines; a source that matches none of the known forms is refused. It
then times each library with CUDA-graph replay (ten launches per replay,
the median of 20, as `chip_smoke.py` times the kernels) at the train step's
levels (batch 4, Cout 256, K 9, m 3, stride 1 and 2, bf16 and fp32 maps,
offsets uniform in [-m, m]) and prints one line per case and a JSON record
of all of them as its last line. Give the parent commit's source and this
one's to compare the two in one run.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lpi_tpu_torch.ops import cuda_build  # noqa: E402
from lpi_tpu_torch.profile_deform import card_line, device_time_ms, window_bound_ms  # noqa: E402

OUT = ROOT / "build" / "window_bwd_split"
M, K, KW, COUT, BATCH = 3, 9, 3, 256, 4
LEVELS = {1: (56, 28, 14, 7, 4), 2: (56, 28, 14, 7)}

# Each form: {variant: [(old, new), ...]}; every `old` must occur once.
FORMS = {
    # a gather per (pixel, tap): blocks [0, dh_blocks) gather d h, the rest
    # reduce the offsets
    "gather + warp per (pixel, tap)": {
        "dh": [("<<<(unsigned)(dh_blocks + off_blocks),", "<<<(unsigned)(dh_blocks),")],
        "offsets": [("<<<(unsigned)(dh_blocks + off_blocks),", "<<<(unsigned)(off_blocks),"),
                    ("if ((long long)blockIdx.x < dh_blocks) {", "if (false) {"),
                    ("((long long)blockIdx.x - dh_blocks) * kBwdWarps",
                     "((long long)blockIdx.x) * kBwdWarps")],
    },
    # d h strip blocks, then offset blocks; a count of 0 drops a kind
    "d h strips + warp per (pixel, tap)": {
        "dh": [("long long off_blocks = (", "long long off_blocks = 0 * (")],
        "offsets": [("long long dh_blocks = (", "long long dh_blocks = 0 * (")],
    },
}


def patched(src: str):
    """{variant: patched source} for the first form whose lines all occur."""
    for form, variants in FORMS.items():
        if all(src.count(old) == 1 for patches in variants.values() for old, _ in patches):
            out = {"full": src}
            for name, patches in variants.items():
                text = src
                for old, new in patches:
                    text = text.replace(old, new)
                out[name] = text
            return form, out
    raise SystemExit("the source matches no known launch form")


def build(sources):
    """Compile every variant of every source in parallel -> {(i, variant): CDLL}."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.nvcc_path()
    procs, forms = {}, {}
    for i, path in enumerate(sources):
        form, variants = patched(Path(path).read_text())
        forms[i] = form
        for name, text in variants.items():
            cu = OUT / f"src{i}_{name}.cu"
            cu.write_text(text)
            lib = OUT / f"src{i}_{name}.so"
            cmd = [nvcc, *cuda_build.NVCC_FLAGS, "-o", str(lib), str(cu)]
            procs[(i, name)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        fn = ctypes.CDLL(str(lib)).lpi_window_taps_bwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[key] = fn
    return forms, libs


def inputs(gen, side, stride, dtype):
    Ho = (side + stride - 1) // stride
    shape = (BATCH, K, Ho, Ho)
    h = torch.randn(BATCH, side, side, K * COUT, device="cuda", generator=gen).to(dtype)
    oy = (torch.rand(*shape, device="cuda", generator=gen) * 2 - 1) * M
    ox = (torch.rand(*shape, device="cuda", generator=gen) * 2 - 1) * M
    g = torch.rand(*shape, device="cuda", generator=gen)
    ct = torch.randn(BATCH, Ho, Ho, COUT, device="cuda", generator=gen)
    return h.contiguous(), oy, ox, g, ct


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_window_bwd_split: no CUDA device", file=sys.stderr)
        return 1
    sources = sys.argv[1:] or [str(cuda_build.CSRC_DIR / "deform_window.cu")]
    card = card_line()
    print(f"card: {card}", flush=True)
    forms, libs = build(sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for stride, sides in LEVELS.items():
        for dtype in (torch.bfloat16, torch.float32):
            for side in sides:
                h, oy, ox, g, ct = inputs(gen, side, stride, dtype)
                Ho = oy.shape[-1]
                outs = (torch.empty_like(h), torch.empty_like(oy), torch.empty_like(ox),
                        torch.empty_like(g))
                vec = 16 // h.element_size()
                bound = window_bound_ms(h, oy, COUT, backward=True)[0]
                first = None  # the first source's full results
                for (i, variant), fn in libs.items():
                    def call(fn=fn):
                        err = fn(h.data_ptr(), oy.data_ptr(), ox.data_ptr(), g.data_ptr(),
                                 ct.data_ptr(), *(t.data_ptr() for t in outs), BATCH, side,
                                 side, Ho, Ho, K, KW, COUT, M, stride,
                                 int(dtype == torch.bfloat16), vec,
                                 torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"launch failed: CUDA error {err}")
                    same = ""
                    if variant == "full":
                        call()
                        got = [t.clone() for t in outs]
                        if first is None:
                            first = got
                        else:  # d h bit for bit, and the offsets' largest difference
                            equal = "equal" if torch.equal(got[0], first[0]) else "NOT equal"
                            diff = max((a - b).abs().max().item()
                                       for a, b in zip(got[1:], first[1:]))
                            same = (f"; d h {equal} bit for bit to the first source's, "
                                    f"d oy/d ox/d gate max abs diff {diff:.3e}")
                    ms = device_time_ms(call, inner=10)
                    row = {"source": sources[i], "form": forms[i], "variant": variant,
                           "stride": stride, "dtype": str(dtype)[6:], "side": side,
                           "ms": ms, "bound_ms": bound, "compared": same}
                    rows.append(row)
                    print(f"{sources[i]} [{forms[i]}] {variant:8s} s{stride} {row['dtype']:8s} "
                          f"b{BATCH} {side}x{side}: {ms:.6f} ms (whole launch's bound "
                          f"{bound:.6f} ms){same}", flush=True)
    print(card)
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
