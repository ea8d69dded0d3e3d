"""The traced sub-window: `torch.profiler` over a few steps or requests,
exported as a Chrome trace into TMPDIR and read back as plain intervals.

Device intervals are the kernels, copies and sets the card ran
(`kernel`, `gpu_memcpy`, `gpu_memset`); spans are the host annotations
(`record_function`): the harness's own (`bench.*`) and the program's
(`predict.*`, `nms.*`). The window is the `bench.window` span.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from benchmark import stats

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"


class Profile:
    """`with Profile() as p:` around the traced sub-window; then
    `p.data` holds its intervals."""

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")  # under TMPDIR
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    self.data = TraceData.from_chrome(json.load(f))
            finally:
                os.remove(path)
        self._prof = None
        return False


class TraceData:
    """Device intervals [(name, start_us, end_us)] and host spans, all on
    the trace's clock."""

    def __init__(self, device: List[Tuple[str, float, float]],
                 spans: List[Tuple[str, float, float]]):
        self.device = device
        self.spans = spans

    @staticmethod
    def from_chrome(trace: dict) -> "TraceData":
        device, spans = [], []
        for e in trace.get("traceEvents", []):
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e["dur"])
            if cat in DEVICE_CATS:
                device.append((e.get("name", "?"), ts, ts + dur))
            elif cat == "user_annotation":
                spans.append((e.get("name", "?"), ts, ts + dur))
        return TraceData(device, spans)

    def window(self) -> Tuple[float, float]:
        ws = [(a, b) for n, a, b in self.spans if n == WINDOW]
        if not ws:
            raise ValueError(f"the trace holds no {WINDOW} span")
        return ws[0]

    def window_s(self) -> float:
        lo, hi = self.window()
        return (hi - lo) * 1e-6

    def busy_s(self) -> float:
        lo, hi = self.window()
        return stats.union_length(((a, b) for _, a, b in self.device), lo, hi) * 1e-6

    def kernel_seconds(self, match) -> float:
        """Device seconds, inside the window, of the ops whose name
        `match(name)` accepts."""
        lo, hi = self.window()
        return sum(min(b, hi) - max(a, lo) for n, a, b in self.device
                   if match(n) and b > lo and a < hi) * 1e-6

    def span_means_ms(self) -> Dict[str, Tuple[float, int]]:
        """Per span name inside the window: (mean ms, count)."""
        lo, hi = self.window()
        acc: Dict[str, List[float]] = defaultdict(list)
        for n, a, b in self.spans:
            if a >= lo and b <= hi and n != WINDOW:
                acc[n].append((b - a) * 1e-3)
        return {n: (sum(v) / len(v), len(v)) for n, v in acc.items()}

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time and the longest idle gaps,
        each named by the innermost span open at its middle."""
        lo, hi = self.window()
        per: Dict[str, float] = defaultdict(float)
        for n, a, b in self.device:
            if b > lo and a < hi:
                per[n] += (min(b, hi) - max(a, lo)) * 1e-6
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
        idle = stats.gaps(((a, b) for _, a, b in self.device), lo, hi)
        idle = sorted(idle, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.open_span((a + b) / 2), (b - a) * 1e-6] for a, b in idle]}

    def open_span(self, t: float) -> str:
        inner: Optional[Tuple[str, float]] = None
        for n, a, b in self.spans:
            if a <= t <= b and n != WINDOW and (inner is None or b - a < inner[1]):
                inner = (n, b - a)
        return inner[0] if inner else "no span"
