"""The deform-window microbenchmark on the card, the counterpart of the JAX
package's `scripts/profile_deform.py`:

    python -m lpi_tpu_torch.profile_deform

Needs a CUDA card and `nvcc` for sm_90a; without a card it exits 1 and
prints no result. At the P3 shape of the 448 px head (batch 4, a 56 x 56
output, 256 channels, K = 9 taps, m = 3) it times

* `bench_kernel`: `window_accumulate_taps` (the gated K-tap sum over the
  pre-padded map [4, 63, 63, 9 x 256]) forward, its backward kernel alone,
  and forward + backward (the gradient of the output's sum for hp, oy and
  ox, through `window_taps_padded`), under zero offsets and under spread
  offsets (N(0, 1) per pixel plus N(0, 1) per tap, clipped to +-m), for an
  fp32 or a bf16 map;
* `bench_single`: `window_accumulate` (the single map [4, 63, 63, 256],
  fp32) the same way;
* `bench_conv`: the deformable conv's forward + backward (gradients for the
  features and the offsets) at one level, by both routes: `deform_conv2d`
  ("pallas": the product map, fp32 and bf16, and the stride-1 window sum)
  and `deform_conv2d_fused`.

The inputs come from `np.random.RandomState(0)` as the JAX script makes
them. Every time is taken two ways: device time (`device_time_ms`, the call
captured in a CUDA graph and replayed 20 times, the median) and eager time
per call (`eager_time_ms`, ten calls back to back, which is what the host
costs where it cannot keep ahead of the card). The lines give ms, the rate
of one read of hp (forward) or of three (forward + backward), and the share
of the least time the card could take (`window_bound_ms`). Each function
returns its numbers as a dict; `chip_smoke.py` runs `profile`.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import numpy as np
import torch

from lpi_tpu_torch.ops import deform_window_kernel as dk
from lpi_tpu_torch.ops.deform_conv import deform_conv2d, deform_conv2d_fused

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # fp32 outside the tensor cores
LEVELS = (56, 28, 14)  # P3, P4, P5 of the 448 px head


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def _median_event_ms(run, reps: int, inner: int) -> float:
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def device_time_ms(fn, reps: int = 20, inner: int = 1) -> float:
    """Device time of one call: `inner` calls captured in a CUDA graph,
    replayed `reps` times between CUDA events; the median per call. The
    graph takes the host's launch cost out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_event_ms(graph.replay, reps, inner)


def eager_time_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Time per call of `inner` back-to-back eager calls: where the host
    cannot keep up with the device, this is the host's cost per call."""
    for _ in range(3):
        fn()

    def run():
        for _ in range(inner):
            fn()

    return _median_event_ms(run, reps, inner)


def bound_ms(nbytes: float, flops: float):
    """The least time on the card, (ms, "bytes" or "operations"): the larger
    of the bytes over the HBM rate and the fp32 operations over the fp32
    rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def weighted_rows(oy: torch.Tensor, ox: torch.Tensor, gate: torch.Tensor, H: int, W: int,
                  m: int, kw: int = 3, stride: int = 1) -> int:
    """The (b, row, column, tap) rows of the unpadded product map h
    [B, H, W, K*Cout] that carry nonzero weight in the window sum at these
    offsets and gates ([B, K, Ho, Wo] fp32), each counted once however many
    outputs read it: the corners floor(o) and floor(o) + 1 per axis that lie
    in the window [-m, m+1] and in the map and whose weight g * hat * hat
    (the kernel's float expression) is not 0. Counted on the offsets'
    device."""
    B, K, Ho, Wo = oy.shape
    dev = oy.device
    k = torch.arange(K, device=dev).view(1, K, 1, 1)
    ys = torch.arange(Ho, device=dev).view(1, 1, Ho, 1) * stride + k // kw - 1
    xs = torch.arange(Wo, device=dev).view(1, 1, 1, Wo) * stride + k % kw - 1
    row0 = (torch.arange(B, device=dev).view(B, 1, 1, 1) * K + k) * H  # (b, k, 0)
    hit = torch.zeros(B * K * H * W, dtype=torch.bool, device=dev)
    fy, fx = torch.floor(oy), torch.floor(ox)
    for a in (0, 1):
        dy = fy + a
        iy = ys + dy.long()
        gwy = gate * torch.clamp(1.0 - (oy - dy).abs(), min=0.0)
        for b in (0, 1):
            dx = fx + b
            ix = xs + dx.long()
            w = gwy * torch.clamp(1.0 - (ox - dx).abs(), min=0.0)
            ok = ((dy >= -m) & (dy <= m + 1) & (dx >= -m) & (dx <= m + 1) & (iy >= 0)
                  & (iy < H) & (ix >= 0) & (ix < W) & (w != 0))
            hit[((row0 + iy) * W + ix)[ok]] = True
    return int(hit.sum())


def window_bound_ms(h: torch.Tensor, oy: torch.Tensor, Cout: int, maps: int = 3,
                    backward: bool = False, offsets=None):
    """Least time of a window sum: the product map h and the `maps` offset
    and gate maps (each of oy's shape, fp32) read once and the fp32 output
    [B, Ho, Wo, Cout] written once; the VJP also writes d h and the maps'
    gradients, and reads the cotangent in place of writing the output. The
    operations: 4 corners x 2 flops per tap and output value, twice that in
    the VJP.

    `offsets` = (ox, gate, stride, m, kw), for the forward over the unpadded
    map: h's bytes are then only its rows that carry weight
    (`weighted_rows`) x Cout x its element size, the least the kernel must
    read; without it, one read of all of h."""
    B, Ho, Wo = oy.shape[0], oy.shape[-2], oy.shape[-1]
    taps = oy.numel() // (B * Ho * Wo)
    out = B * Ho * Wo * Cout
    h_bytes, map_bytes = h.numel() * h.element_size(), maps * oy.numel() * 4
    if offsets is not None:
        if backward:
            raise ValueError("the weighted rows bound the forward only")
        ox, gate, stride, m, kw = offsets
        h_bytes = (weighted_rows(oy, ox, gate, h.shape[1], h.shape[2], m, kw, stride)
                   * Cout * h.element_size())
    if backward:
        return bound_ms(2 * h_bytes + 2 * map_bytes + 4 * out, out * taps * 16)
    return bound_ms(h_bytes + map_bytes + 4 * out, out * taps * 8)


def padded_inputs(B: int, H: int, W: int, C: int, m: int, K: int, dtype):
    """The JAX script's inputs (`scripts/profile_deform.py:45-51`), on the
    card: hp [B, H+2m+1, W+2m+1, K*C] in `dtype`, a gate of ones, zero
    offsets and spread offsets [B, K, H, W] fp32."""
    rng = np.random.RandomState(0)
    hp = rng.randn(B, H + 2 * m + 1, W + 2 * m + 1, K * C).astype(np.float32)
    spread = np.clip(rng.randn(B, K, H, W) * 1.0 + rng.randn(1, K, 1, 1), -m, m)
    hp = torch.from_numpy(hp).cuda().to(dtype)
    spread = torch.from_numpy(spread.astype(np.float32)).cuda()
    return hp, torch.ones_like(spread), torch.zeros_like(spread), spread


def _timed(fn) -> dict:
    return {"ms": device_time_ms(fn), "eager_ms": eager_time_ms(fn)}


def _bench_sum(hp, gate, offsets: dict, m: int, K: int, log) -> dict:
    """Forward, the backward kernel alone, and forward + backward of one
    window sum under each of `offsets`; gate None is the single map
    (`window_accumulate`, offsets [B, Ho, Wo])."""
    C = hp.shape[-1] // K
    o = next(iter(offsets.values()))
    maps = 2 if gate is None else 3
    fwd_bound = window_bound_ms(hp, o, C, maps)[0]
    bwd_bound = window_bound_ms(hp, o, C, maps, backward=True)[0]
    hp_mb = hp.numel() * hp.element_size() / 1e6
    ct = torch.ones(*o.shape[:1], *o.shape[-2:], C, device=hp.device)
    hp_leaf = hp.detach().requires_grad_(True)
    out = {"bound_ms": fwd_bound, "backward_bound_ms": bwd_bound}
    for name, o in offsets.items():
        oy, ox = o.clone().requires_grad_(True), o.clone().requires_grad_(True)
        if gate is None:
            calls = (lambda: dk.window_accumulate(hp, o, o, m),
                     lambda: dk.window_accumulate_backward(hp, o, o, ct, m),
                     lambda: dk.window_single(hp_leaf, oy, ox, m))
        else:
            calls = (lambda: dk.window_accumulate_taps(hp, o, o, gate, m, K),
                     lambda: dk.window_accumulate_taps_backward(hp, o, o, gate, ct, m, K),
                     lambda: dk.window_taps_padded(hp_leaf, oy, ox, gate, m, K))
        fwd, bwd, diff = calls
        r = {"fwd": _timed(fwd), "bwd": _timed(bwd),
             "fwd_bwd": _timed(lambda: torch.autograd.grad(diff().sum(), (hp_leaf, oy, ox)))}
        f, b, fb = r["fwd"], r["bwd"], r["fwd_bwd"]
        log(f"fwd {name:6s}: {f['ms']:8.4f} ms  hp-read {hp_mb / f['ms']:6.0f} GB/s  "
            f"{100 * fwd_bound / f['ms']:5.1f}% of the byte bound ({fwd_bound:.4f} ms); "
            f"eager {f['eager_ms']:.4f} ms/call")
        log(f"bwd {name:6s}: {b['ms']:8.4f} ms  (backward kernel alone) "
            f"{100 * bwd_bound / b['ms']:5.1f}% of the byte bound ({bwd_bound:.4f} ms); "
            f"eager {b['eager_ms']:.4f} ms/call")
        log(f"f+b {name:6s}: {fb['ms']:8.4f} ms  3x hp {3 * hp_mb / fb['ms']:6.0f} GB/s  "
            f"{100 * (fwd_bound + bwd_bound) / fb['ms']:5.1f}% of the byte bound "
            f"({fwd_bound + bwd_bound:.4f} ms); eager {fb['eager_ms']:.4f} ms/call")
        out[name] = r
    return out


def bench_kernel(B=4, H=56, W=56, C=256, m=3, K=9, dtype=torch.float32, log=print) -> dict:
    """`window_accumulate_taps` at an H x W output, Cout = C, with a map of
    `dtype`: {"bound_ms", "backward_bound_ms", "zero": ..., "spread": ...},
    each offset case {"fwd", "bwd", "fwd_bwd"} of {"ms", "eager_ms"}."""
    hp, gate, zero, spread = padded_inputs(B, H, W, C, m, K, dtype)
    return _bench_sum(hp, gate, {"zero": zero, "spread": spread}, m, K, log)


def bench_single(B=4, H=56, W=56, C=256, m=3, log=print) -> dict:
    """`window_accumulate` (fp32 only) at an H x W output with C channels;
    the dict of `bench_kernel`."""
    hp, _, zero, spread = padded_inputs(B, H, W, C, m, 1, torch.float32)
    return _bench_sum(hp, None, {"zero": zero[:, 0], "spread": spread[:, 0]}, m, 1, log)


def bench_conv(B=4, H=56, W=56, C=256, log=print) -> dict:
    """Forward + backward (gradients for the features and the offsets) of
    the deformable conv at one level, the JAX script's inputs: {"pallas
    float32", "pallas bfloat16" (the product map's type), "fused"} of
    {"ms", "eager_ms"}."""
    rng = np.random.RandomState(0)
    arrays = (rng.randn(B, H, W, C), rng.randn(B, H, W, 18) * 1.0,
              rng.randn(3, 3, C, C) * 0.05)
    feats, offs, w = (torch.from_numpy(a.astype(np.float32)).cuda() for a in arrays)
    feats.requires_grad_(True)
    offs.requires_grad_(True)
    routes = {"pallas float32": lambda: deform_conv2d(feats, offs, w),
              "pallas bfloat16": lambda: deform_conv2d(feats, offs, w,
                                                       compute_dtype=torch.bfloat16),
              "fused": lambda: deform_conv2d_fused(feats, offs, w)}
    out = {}
    for route, conv in routes.items():
        r = out[route] = _timed(lambda: torch.autograd.grad(conv().sum(), (feats, offs)))
        log(f"deform conv f+b {H}x{W} {route}: {r['ms']:8.4f} ms device, eager "
            f"{r['eager_ms']:.4f} ms/call")
    return out


def profile(log=print) -> dict:
    """The JAX script's runs: `bench_kernel` in fp32 and bf16, `bench_single`,
    and `bench_conv` at P3, P4 and P5."""
    out = {"window_accumulate_taps": {}, "conv": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        log(f"=== window_accumulate_taps P3@448 b4 hp={name} ===")
        out["window_accumulate_taps"][name] = bench_kernel(dtype=dtype, log=log)
    log("=== window_accumulate P3@448 b4 hp=float32 (one map, 256 channels) ===")
    out["window_accumulate"] = bench_single(log=log)
    log("=== full deform conv f+b per level ===")
    for side in LEVELS:
        out["conv"][side] = bench_conv(H=side, W=side, log=log)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_deform: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {card_line()}; torch {torch.__version__}, cuda {torch.version.cuda}",
          flush=True)
    profile(lambda *a: print(*a, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
