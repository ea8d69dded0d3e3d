"""The benchmark's arithmetic on synthetic inputs: the idle share from
overlapping intervals, the tail and the rate over a window that holds a
stall, the trace reader, and the window sums' bound."""

import math

import pytest
import torch

from benchmark import stats
from benchmark.counts import glip as counts
from benchmark.peaks import FP32_FLOPS, HBM_BYTES_PER_S
from benchmark.trace import TraceData


def test_union_and_gaps_of_overlapping_intervals():
    iv = [(0, 4), (2, 6), (8, 9), (8.5, 12), (20, 30)]
    assert stats.union_length(iv, 0, 15) == 6 + 4
    assert stats.union_length(iv, 3, 25) == 3 + 4 + 5
    assert stats.gaps(iv, 0, 15) == [(6, 8), (12, 15)]
    assert stats.gaps([], 1, 2) == [(1, 2)]


def test_tail_and_rate_count_every_request_of_a_window_with_a_stall():
    lat = [40.0] * 180 + [900.0] * 20  # a stall delays twenty requests
    assert stats.percentile(lat, 95) == 900.0
    assert stats.percentile(lat[:190], 95) == pytest.approx(40.0 + 0.55 * 860.0)
    assert stats.percentile(lat, 50) == 40.0
    window = 180 * 0.040 + 20 * 0.900
    assert stats.rate(len(lat), window) == pytest.approx(200 / 25.2)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_norm_gap():
    assert stats.norm_gap(1.1, 1.0, 0.5) == pytest.approx(0.1)
    assert stats.norm_gap(0.0, 1.0, 0.5) == 1.0
    assert stats.norm_gap(0.02, 0.01, 0.5) == pytest.approx(0.02)  # small leaf: over the median


def _trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 100, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "bench.step", "ts": 100, "dur": 40},
          {"ph": "X", "cat": "user_annotation", "name": "bench.step", "ts": 150, "dur": 50},
          {"ph": "X", "cat": "kernel", "name": "window_taps_kernel<x>", "ts": 90, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 115, "dur": 10},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 160, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 195, "dur": 20},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 100, "dur": 5}]
    return TraceData.from_chrome({"traceEvents": ev})


def test_trace_reader_busy_idle_kernels_and_breakdown():
    t = _trace()
    assert t.window() == (100, 200) and t.window_s() == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx(40e-6)  # (100, 125) + (160, 170) + (195, 200)
    assert t.kernel_seconds(lambda n: "window_taps" in n) == pytest.approx(20e-6)
    assert t.span_means_ms() == {"bench.step": (pytest.approx(0.045), 2)}
    b = t.breakdown()
    assert b["device_ops"] == [["window_taps_kernel<x>", pytest.approx(20e-6)],
                               ["gemm", pytest.approx(15e-6)],
                               ["Memcpy HtoD", pytest.approx(10e-6)]]
    assert b["idle_gaps"] == [["no span", pytest.approx(35e-6)],  # (125, 160)
                              ["bench.step", pytest.approx(25e-6)]]  # (170, 195)


def test_weighted_rows_against_a_brute_force_count():
    g = torch.Generator().manual_seed(0)
    B, K, H, W, m = 1, 9, 6, 7, 3
    for stride in (1, 2):
        Ho, Wo = -(-H // stride), -(-W // stride)
        oy = torch.clamp(torch.randn(B, K, Ho, Wo, generator=g) * 2, -m, m)
        ox = torch.clamp(torch.randn(B, K, Ho, Wo, generator=g) * 2, -m, m)
        oy[0, 0, 0, 0] = 1.0  # an integer offset: its second corner has weight 0
        gate = torch.rand(B, K, Ho, Wo, generator=g)
        hit = set()
        for k in range(K):
            for y in range(Ho):
                for x in range(Wo):
                    for dy in (math.floor(oy[0, k, y, x]), math.floor(oy[0, k, y, x]) + 1):
                        for dx in (math.floor(ox[0, k, y, x]), math.floor(ox[0, k, y, x]) + 1):
                            w = (float(gate[0, k, y, x])
                                 * max(0.0, 1 - abs(float(oy[0, k, y, x]) - dy))
                                 * max(0.0, 1 - abs(float(ox[0, k, y, x]) - dx)))
                            iy, ix = y * stride + k // 3 - 1 + dy, x * stride + k % 3 - 1 + dx
                            if w != 0 and 0 <= iy < H and 0 <= ix < W:
                                hit.add((k, iy, ix))
        assert counts.weighted_rows(oy, ox, gate, H, W, m, 3, stride) == len(hit)


def test_window_bound_is_the_larger_of_bytes_and_operations():
    assert counts.bound_s(HBM_BYTES_PER_S, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, FP32_FLOPS) == pytest.approx(1.0)
    oy = torch.zeros(1, 9, 4, 4)
    gate = torch.ones(1, 9, 4, 4)
    rec = [(oy, oy, gate, 4, 4, 1)]
    out, maps = 4 * 4 * 8, 3 * oy.numel() * 4
    hit = counts.weighted_rows(oy, oy, gate, 4, 4, 3)
    want = (counts.bound_s(hit * 8 * 2 + maps + 4 * out, out * 9 * 8)
            + counts.bound_s(2 * 16 * 9 * 8 * 2 + 2 * maps + 4 * out, out * 9 * 16))
    assert counts.window_bound_s(rec, 8, 2, 3) == pytest.approx(want)
