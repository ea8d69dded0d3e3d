"""Time the fused deformable conv of two or more kernel sources side by side.

    python scripts/torch_fused_compare.py [SOURCE.cu ...]

Needs a CUDA card and `nvcc` for sm_90a. Each source given (default: the
package's own `lpi_tpu_torch/csrc/fused_deform.cu`) is built as it is, with
`-Xptxas -v`, into its own library under `build/fused_compare/`; the script
prints the registers, stack and spills of each of its kernels (the whole
compiler log goes beside the library). Two more libraries per source come
from patched copies of its backward launch lines (plain text replacements;
a source that matches none is refused): the sample launch with the d f
blocks alone, and with the offset-gradient blocks alone.

Then, at every level of the 448 px head that the fused conv sees (the
stride-1 and stride-2 input sides of `chip_smoke.py`), batch 1 and 4, C =
Cout = 256, K 9, m 3, inputs as `chip_smoke.fused_inputs` makes them, it
times each source's forward (`lpi_fused_deform_fwd`) and backward
(`lpi_fused_deform_bwd`, without and with d W) with CUDA-graph replay (ten
calls a replay, the median of 20), once in the order given and once in
reverse, and prints the mean of the two beside the bound
(`chip_smoke.fused_bound_ms`), the largest difference from the plain
versions and whether each output equals the first source's bit for bit. At
batch 4 it also splits each backward by kernel with `torch.profiler` (U
product, sample launch, d W partial tiles and their sum), and times the
sample launch's two halves alone from the patched libraries. Last, the per
train step (batch 4, backward without d W) and per predict forward (batch
1) sums of each source, the card, and a JSON record of every row.

To compare with the parent commit, unpack it with `git archive` into
`build/` (which `.gitignore` lists) and give its source first:

    python scripts/torch_fused_compare.py \\
        build/parent/lpi_tpu_torch/csrc/fused_deform.cu lpi_tpu_torch/csrc/fused_deform.cu
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

from chip_smoke import (INPAD_SHAPES, S2_SHAPES, TOWERS, fused_bound_ms,  # noqa: E402
                        fused_inputs)
from lpi_tpu_torch.ops import cuda_build  # noqa: E402
from lpi_tpu_torch.ops import fused_deform_kernel as fk  # noqa: E402
from lpi_tpu_torch.profile_deform import card_line, device_time_ms  # noqa: E402

OUT = ROOT / "build" / "fused_compare"
M, K, KW, C = 3, 9, 3, 256
LEVELS = {1: INPAD_SHAPES, 2: S2_SHAPES}  # {stride: {input side: launches per tower}}
BATCHES = (1, 4)
ENTRIES = ("lpi_fused_deform_fwd", "lpi_fused_deform_bwd")
KERNELS = ("fused_fwd_kernel", "u_product_kernel", "fused_bwd_sample_kernel",
           "dw_partial_kernel", "dw_sum_kernel")
# {variant: [(old, new), ...]}: every `old` must occur once in the source
HALVES = {
    "df": [("const long long off_blocks = (", "const long long off_blocks = 0 * (")],
    "offsets": [("const long long df_blocks = (", "const long long df_blocks = 0 * (")],
}


def check_source(text: str, path: str) -> None:
    """Refuse a source without both entry points."""
    missing = [e for e in ENTRIES if f'extern "C" int {e}(' not in text]
    if missing:
        raise SystemExit(f"{path} has no entry point {', '.join(missing)}")


def patched(src: str) -> dict:
    """{variant: source}: the source as it is ("full") and its halves."""
    out = {"full": src}
    for name, patches in HALVES.items():
        text = src
        for old, new in patches:
            if src.count(old) != 1:
                raise SystemExit(f"the source matches no known launch form ({old!r})")
            text = text.replace(old, new)
        out[name] = text
    return out


def nvcc_command(nvcc: str, source: str, lib: str, verbose: bool = True) -> list:
    return [nvcc, *cuda_build.NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", lib,
            source]


def kernel_resources(log: str) -> list:
    """(function, "N registers", stack and spill line) of every kernel of
    the fused conv in a `ptxas -v` log."""
    out, name, frame = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name, frame = entry.group(1), ""
        elif "bytes stack frame" in line:
            frame = line.strip()
        else:
            used = re.search(r"Used (\d+) registers", line)
            if used and name and any(k in name for k in KERNELS):
                out.append((name, f"{used.group(1)} registers", frame))
    return out


def _entries(lib: Path):
    so = ctypes.CDLL(str(lib))
    fwd, bwd = so.lpi_fused_deform_fwd, so.lpi_fused_deform_bwd
    fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    splits = getattr(so, "lpi_fused_deform_dw_splits", None)
    if splits is not None:
        splits.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 3
        splits.restype = ctypes.c_int
    return fwd, bwd, splits


def build(sources):
    """Compile every variant of every source in parallel ->
    {(i, variant): (fwd, bwd, d W splits or None)}."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.nvcc_path()
    procs = {}
    for i, path in enumerate(sources):
        text = Path(path).read_text()
        check_source(text, path)
        for name, variant in patched(text).items():
            cu = Path(path) if name == "full" else OUT / f"src{i}_{name}.cu"
            if name != "full":
                cu.write_text(variant)
            lib = OUT / f"src{i}_{name}.so"
            cmd = nvcc_command(nvcc, str(cu), str(lib), verbose=name == "full")
            procs[(i, name)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for (i, name), (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {sources[i]} ({name}):\n{log}")
        if name == "full":
            (OUT / f"src{i}.ptxas.txt").write_text(log)
            for kernel, regs, frame in kernel_resources(log):
                print(f"{sources[i]}: {kernel}: {regs}; {frame}", flush=True)
        libs[(i, name)] = _entries(lib)
    return libs


class Case:
    """One level's inputs, and each library's calls on them into its own
    output tensors."""

    def __init__(self, gen, side, stride, batch):
        self.f, self.oy, self.ox, self.g, self.w, self.ct = fused_inputs(gen, side, stride,
                                                                         batch, C)
        B, H, W, _ = self.f.shape
        self.dims = (B, H, W, C, self.oy.shape[2], self.oy.shape[3], K, KW, C, M, stride)
        self.npix = B * self.oy.shape[2] * self.oy.shape[3]

    def forward(self, fns):
        fwd = fns[0]
        out = torch.empty(*self.oy.shape[:1], *self.oy.shape[2:], C, device="cuda")
        ptrs = [t.data_ptr() for t in (self.f, self.oy, self.ox, self.g, self.w)]

        def call():
            err = fwd(*ptrs, out.data_ptr(), *self.dims, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"forward launch failed: CUDA error {err}")
        return call, (out,)

    def backward(self, fns, need_dw):
        _, bwd, splits_fn = fns
        splits = (splits_fn or fk._dw_splits)(self.npix, K, C, C)
        u = torch.empty(self.npix, K * C, device="cuda")
        outs = [torch.empty_like(self.f), *(torch.empty_like(self.oy) for _ in range(3))]
        partial = dw = None
        if need_dw:
            dw = torch.empty_like(self.w)
            partial = torch.empty(splits, K, C, C, device="cuda")
            outs.append(dw)
        # the call holds every tensor it writes: a scratch known only by its
        # pointer would be freed (and graph capture empties the cache)
        held = [self.f, self.oy, self.ox, self.g, self.w, self.ct, u, *outs[:4], partial, dw]
        ptrs = [None if t is None else t.data_ptr() for t in held]

        def call():
            err = bwd(*ptrs, *self.dims, splits, 4, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"backward launch failed: CUDA error {err}")
        call.held = held
        return call, tuple(outs)


def timed(calls) -> list:
    """Each call's device time: the mean of one timing in the order given
    and one in reverse."""
    times = [[] for _ in calls]
    for i in [*range(len(calls)), *reversed(range(len(calls)))]:
        times[i].append(device_time_ms(calls[i], inner=10))
    return [sum(t) / len(t) for t in times]


def kernel_split(call, n: int = 3) -> dict:
    """Device ms per call of each kernel of the fused conv that `call`
    launches, from `torch.profiler` over `n` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        for name in KERNELS:
            if name in e.key:
                out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / n
    return out


def compare(label, kind, calls, outs, want, bound, row, rows, sources):
    """Run each source once, hold it to the plain `want` and to the first
    source's bits, time all, print and record one line per source."""
    for call in calls:
        call()
    torch.cuda.synchronize()
    times = timed(calls)
    for i, (ms, out) in enumerate(zip(times, outs)):
        err = max((a - b).abs().max().item() for a, b in zip(out, want))
        scale = max(max(1.0, b.abs().max().item()) for b in want)
        same = all(torch.equal(a, b) for a, b in zip(out, outs[0]))
        rows.append({**row, "kind": kind, "source": sources[i], "ms": ms, "bound_ms": bound,
                     "max_abs_err": err, "within_1e-5": err <= 1e-5 * scale,
                     "bits_equal_first": same})
        print(f"{sources[i]} {kind} {label}: {ms:.6f} ms ({100 * bound / ms:.1f}% of the bound "
              f"{bound:.6f} ms; x{times[0] / ms:.3f} of the first), max abs err {err:.3e} "
              f"(tol 1e-5 x {scale:.3f}), {'equal' if same else 'NOT equal'} bit for bit to "
              f"the first", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fused_compare: no CUDA device", file=sys.stderr)
        return 1
    sources = sys.argv[1:] or [str(cuda_build.CSRC_DIR / "fused_deform.cu")]
    card = card_line()
    print(f"card: {card}", flush=True)
    libs = build(sources)
    full = [libs[(i, "full")] for i in range(len(sources))]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, splits = [], []
    for stride, shapes in LEVELS.items():
        for batch in BATCHES:
            for side in shapes:
                case = Case(gen, side, stride, batch)
                args = (case.f, case.oy, case.ox, case.g, case.w)
                label = f"s{stride} b{batch} in {side}x{side}"
                row = {"stride": stride, "batch": batch, "side": side}
                fwd = [case.forward(fns) for fns in full]
                compare(label, "fwd", [c for c, _ in fwd], [o for _, o in fwd],
                        (fk.fused_deform_reference(*args, M, KW, stride),),
                        fused_bound_ms(case.f, case.oy, C, C)[0], row, rows, sources)
                want = fk.fused_deform_backward_reference(*args, case.ct, M, KW, stride)
                for need_dw in (False, True):
                    bwd = [case.backward(fns, need_dw) for fns in full]
                    compare(label, "bwd_dw" if need_dw else "bwd", [c for c, _ in bwd],
                            [o for _, o in bwd], want if need_dw else want[:4],
                            fused_bound_ms(case.f, case.oy, C, C, backward=True, dw=need_dw)[0],
                            row, rows, sources)
                if batch != 4:
                    continue
                for i, src in enumerate(sources):
                    split = {f"{k} (d W)": v for k, v in
                             kernel_split(case.backward(full[i], True)[0]).items()}
                    split.update(kernel_split(case.backward(full[i], False)[0]))
                    for half in HALVES:
                        call = case.backward(libs[(i, half)], False)[0]
                        ms = {}
                        for _ in range(3):  # the profiler now and then misses a kernel
                            ms = kernel_split(call)
                            if "fused_bwd_sample_kernel" in ms:
                                break
                        split[f"fused_bwd_sample_kernel ({half} alone)"] = \
                            ms.get("fused_bwd_sample_kernel", float("nan"))
                    splits.append({**row, "source": src, "split_ms": split})
                    print(f"{src} split {label}: " + ", ".join(
                        f"{k} {v:.6f} ms" for k, v in split.items()), flush=True)
    for src in sources:
        for kind, batch, what in (("fwd", 4, "per train step"), ("bwd", 4, "per train step"),
                                  ("bwd_dw", 4, "per train step with d W"),
                                  ("fwd", 1, "per predict forward")):
            ms = bound = 0.0
            for r in rows:
                if r["source"] == src and r["kind"] == kind and r["batch"] == batch:
                    n = LEVELS[r["stride"]][r["side"]] * TOWERS
                    ms, bound = ms + n * r["ms"], bound + n * r["bound_ms"]
            print(f"{src}: {kind} {what} (b{batch}): {ms:.4f} ms, bound {bound:.4f} ms",
                  flush=True)
        per_step = {}
        for s in splits:
            if s["source"] == src:
                n = LEVELS[s["stride"]][s["side"]] * TOWERS
                for k, v in s["split_ms"].items():
                    per_step[k] = per_step.get(k, 0.0) + n * v
        print(f"{src}: backward split per train step (b4): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in per_step.items()), flush=True)
    print(card)
    print(json.dumps({"card": card, "sources": sources, "rows": rows, "splits": splits}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
