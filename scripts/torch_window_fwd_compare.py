"""Time the deform-window forward of two or more kernel sources side by side.

    python scripts/torch_window_fwd_compare.py [SOURCE.cu ...]

Needs a CUDA card and `nvcc` for sm_90a. Each source given (default: the
package's own `lpi_tpu_torch/csrc/deform_window.cu`) is built as it is, with
`-Xptxas -v`, into its own library under `build/window_fwd_compare/`; the
script prints each forward instance's registers, stack and spills (the
whole compiler log goes beside the library). Then, at every level of the
448 px head that rows 1f and 2f see (the stride-1 and stride-2 input sides
of `chip_smoke.py`), bf16 and fp32 maps, batch 1 and 4, Cout 256, K 9, m 3,
offsets uniform in [-m, m] with integers and the +-m edges mixed in and
gates in [0, 1) with exact 0 and 1 mixed in, it times each source's
`lpi_window_taps_fwd` with CUDA-graph replay (ten launches a replay, the
median of 20), once in the order given and once in reverse, and prints the
mean of the two beside the bound from the rows of h that carry weight, the
largest difference from the plain version and whether the output equals
the first source's bit for bit. Rows 3f and 4f (`lpi_window_padded_fwd`)
are timed the same way at the microbenchmark's P3 shape with spread
offsets, and one `grid_sample` call beside row 4. Then the time of a launch
of next to no work (`zero_` of 64 floats) in the same timing, the per train
step (batch 4, bf16) and per predict forward (batch 1, bf16) sums of each
source, the card, and a JSON record of every row as the last line.

To compare with the parent commit, unpack it with `git archive` into
`build/` (which `.gitignore` lists) and give its source first:

    python scripts/torch_window_fwd_compare.py \\
        build/parent/lpi_tpu_torch/csrc/deform_window.cu lpi_tpu_torch/csrc/deform_window.cu
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import INPAD_SHAPES, S2_SHAPES, TOWERS, grid_sample_inputs  # noqa: E402
from lpi_tpu_torch.ops import cuda_build  # noqa: E402
from lpi_tpu_torch.ops import deform_window_kernel as dk  # noqa: E402
from lpi_tpu_torch.profile_deform import (card_line, device_time_ms, padded_inputs,  # noqa: E402
                                          window_bound_ms)

OUT = ROOT / "build" / "window_fwd_compare"
M, K, KW, COUT = 3, 9, 3, 256
LEVELS = {1: INPAD_SHAPES, 2: S2_SHAPES}  # {stride: {input side: launches per tower}}
ENTRIES = ("lpi_window_taps_fwd", "lpi_window_padded_fwd")
REFERENCES = {1: dk.window_accumulate_taps_inpad_reference,
              2: dk.window_accumulate_taps_s2_reference}


def check_source(text: str, path: str) -> None:
    """Refuse a source without both forward entry points."""
    missing = [e for e in ENTRIES if f'extern "C" int {e}(' not in text]
    if missing:
        raise SystemExit(f"{path} has no forward entry point {', '.join(missing)}")


def nvcc_command(nvcc: str, source: str, lib: str) -> list:
    return [nvcc, *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, source]


def forward_resources(log: str) -> list:
    """(function, "N registers", stack and spill line) of every forward
    kernel (`window_taps_kernel`) in a `ptxas -v` log."""
    out, name, frame = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name, frame = entry.group(1), ""
        elif "bytes stack frame" in line:
            frame = line.strip()
        else:
            used = re.search(r"Used (\d+) registers", line)
            if used and name and "window_taps_kernel" in name:
                out.append((name, f"{used.group(1)} registers", frame))
    return out


def build(sources):
    """Compile every source in parallel -> [(taps entry, padded entry)]."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.nvcc_path()
    procs = []
    for i, path in enumerate(sources):
        check_source(Path(path).read_text(), path)
        lib = OUT / f"src{i}.so"
        procs.append((subprocess.Popen(nvcc_command(nvcc, str(path), str(lib)),
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib))
    entries = []
    for i, (proc, lib) in enumerate(procs):
        log, _ = proc.communicate()
        (OUT / f"src{i}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {sources[i]}:\n{log}")
        for name, regs, frame in forward_resources(log):
            print(f"{sources[i]}: {name}: {regs}; {frame}", flush=True)
        so = ctypes.CDLL(str(lib))
        fns = []
        for e in ENTRIES:
            fn = getattr(so, e)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns.append(fn)
        entries.append(tuple(fns))
    return entries


def inputs(gen, batch, side, stride, dtype):
    """Map, offsets and gate as `chip_smoke.offset_inputs` makes them."""
    Ho = (side + stride - 1) // stride
    shape = (batch, K, Ho, Ho)
    h = torch.randn(batch, side, side, K * COUT, device="cuda", generator=gen).to(dtype)
    oy = (torch.rand(*shape, device="cuda", generator=gen) * 2 - 1) * M
    ox = (torch.rand(*shape, device="cuda", generator=gen) * 2 - 1) * M
    oy.view(-1)[::7] = torch.round(oy.view(-1)[::7])
    ox.view(-1)[::5] = torch.round(ox.view(-1)[::5])
    oy.view(-1)[::11] = float(M)
    ox.view(-1)[::13] = -float(M)
    g = torch.rand(*shape, device="cuda", generator=gen)
    g.view(-1)[::6] = 0.0
    g.view(-1)[::17] = 1.0
    return h.contiguous(), oy, ox, g


def caller(fn, h, oy, ox, gate, out, stride, Kc, kw):
    """A call of one source's entry on these tensors (the wrapper's `vec`)."""
    B, H, W, KC = h.shape
    Cout, (Ho, Wo) = KC // Kc, oy.shape[-2:]
    vec = 16 // h.element_size()

    def call():
        err = fn(h.data_ptr(), oy.data_ptr(), ox.data_ptr(),
                 None if gate is None else gate.data_ptr(), out.data_ptr(), B, H, W, Ho, Wo,
                 Kc, kw, Cout, M, stride, int(h.dtype == torch.bfloat16), vec,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return call


def timed(calls) -> list:
    """Each call's device time: the mean of one timing in the order given
    and one in reverse."""
    times = [[] for _ in calls]
    for i in [*range(len(calls)), *reversed(range(len(calls)))]:
        times[i].append(device_time_ms(calls[i], inner=10))
    return [sum(t) / len(t) for t in times]


def compare(label, calls, outs, want, bound, row, rows, sources):
    """Run each source once, hold it to the plain `want` and to the first
    source's bits, time all, print and record one line per source."""
    for call in calls:
        call()
    torch.cuda.synchronize()
    times = timed(calls)
    scale = max(1.0, want.abs().max().item())
    for i, (ms, out) in enumerate(zip(times, outs)):
        err = (out - want).abs().max().item()
        same = torch.equal(out, outs[0])
        rows.append({**row, "source": sources[i], "ms": ms, "bound_ms": bound,
                     "max_abs_err": err, "within_1e-5": err <= 1e-5 * scale,
                     "bits_equal_first": same})
        print(f"{sources[i]} {label}: {ms:.6f} ms ({100 * bound / ms:.1f}% of the bound "
              f"{bound:.6f} ms; x{times[0] / ms:.3f} of the first), max abs err {err:.3e} "
              f"(tol 1e-5 x {scale:.3f}), {'equal' if same else 'NOT equal'} bit for bit "
              f"to the first", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_window_fwd_compare: no CUDA device", file=sys.stderr)
        return 1
    sources = sys.argv[1:] or [str(cuda_build.CSRC_DIR / "deform_window.cu")]
    card = card_line()
    print(f"card: {card}", flush=True)
    entries = build(sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for stride, shapes in LEVELS.items():
        for batch in (1, 4):
            for dtype in (torch.bfloat16, torch.float32):
                for side in shapes:
                    h, oy, ox, g = inputs(gen, batch, side, stride, dtype)
                    outs = [torch.empty(batch, *oy.shape[-2:], COUT, device="cuda")
                            for _ in sources]
                    calls = [caller(e[0], h, oy, ox, g, out, stride, K, KW)
                             for e, out in zip(entries, outs)]
                    bound = window_bound_ms(h, oy, COUT, offsets=(ox, g, stride, M, KW))[0]
                    row = {"row": f"{stride}f", "stride": stride, "batch": batch,
                           "dtype": str(dtype)[6:], "side": side}
                    compare(f"row {stride}f b{batch} {row['dtype']} in {side}x{side}", calls,
                            outs, REFERENCES[stride](h, oy, ox, g, M, K, KW), bound, row, rows,
                            sources)
    # rows 3f and 4f at the microbenchmark's P3 shape, spread offsets
    for label, Kc, dtype in (("3f", K, torch.bfloat16), ("3f", K, torch.float32),
                             ("4f", 1, torch.float32)):
        hp, gate, _, o = padded_inputs(4, 56, 56, COUT, M, Kc, dtype)
        gate = gate if Kc > 1 else None
        outs = [torch.empty(4, 56, 56, COUT, device="cuda") for _ in sources]
        calls = [caller(e[1], hp, o, o, gate, out, 1, Kc, 1) for e, out in zip(entries, outs)]
        bound = window_bound_ms(hp, o if Kc > 1 else o[:, 0], COUT, maps=3 if Kc > 1 else 2)[0]
        want = dk.window_accumulate_taps_reference(hp, o, o, gate, M, Kc)
        row = {"row": label, "stride": 1, "batch": 4, "dtype": str(dtype)[6:], "side": 56}
        compare(f"row {label} b4 {row['dtype']} out 56x56", calls, outs, want, bound, row, rows,
                sources)
        if Kc == 1:
            inp, grid = grid_sample_inputs(hp, o[:, 0], o[:, 0], M)
            ms = device_time_ms(lambda: torch.nn.functional.grid_sample(
                inp, grid, mode="bilinear", padding_mode="zeros", align_corners=True), inner=10)
            rows.append({**row, "source": "grid_sample", "ms": ms})
            print(f"grid_sample row 4f b4 float32 out 56x56: {ms:.6f} ms", flush=True)
    # what a launch of next to no work costs in the same CUDA-graph timing
    tiny = torch.zeros(64, device="cuda")
    floor = device_time_ms(tiny.zero_, inner=10)
    print(f"launch floor (zero_ of 64 floats, same timing): {floor:.6f} ms", flush=True)
    for src in sources:
        for stride, shapes in LEVELS.items():
            for batch, what in ((4, "per train step"), (1, "per predict forward")):
                ms = bound = 0.0
                for r in rows:
                    if (r["source"] == src and r["row"] == f"{stride}f" and r["batch"] == batch
                            and r["dtype"] == "bfloat16"):
                        n = shapes[r["side"]] * TOWERS
                        ms, bound = ms + n * r["ms"], bound + n * r["bound_ms"]
                print(f"{src}: row {stride}f {what} (b{batch}, bf16): {ms:.4f} ms, bound "
                      f"{bound:.4f} ms", flush=True)
    print(card)
    print(json.dumps({"card": card, "sources": sources, "launch_floor_ms": floor, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
