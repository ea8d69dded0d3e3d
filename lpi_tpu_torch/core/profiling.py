"""Profiling and accounting: traces, step timing, device memory, FLOPs
(counterpart of `lpi_tpu/core/profiling.py`; the reference's wall-clock
ETA logging, `torch.cuda.max_memory_allocated` prints and thop-based
FLOP counter).

* `trace(logdir)`: `torch.profiler.profile` over the CPU and, where there
  is one, the card; the Chrome trace JSON lands in `logdir`
  (`tensorboard_trace_handler`, which needs no TensorBoard package);
* `StepTimer`: wall clock per step, with `torch.cuda.synchronize()` when
  the value handed to `stop` lives on the card;
* `device_memory_stats`: the caching allocator's bytes in use and peak, and
  the card's total memory;
* `compiled_flops`: the FLOPs of one call, from
  `torch.utils.flop_counter.FlopCounterMode`;
* `span(name)`: a named stretch of host time, always on. It is a
  `record_function` range, so a `torch.profiler` run (`trace`, the
  benchmark's traced sub-window) places it on the clock of the card's
  kernels and copies; its seconds and count also add up in an in-memory
  table, `span_totals()`, which the set-up (no profiler running) is read
  from. A profiler makes the host's work around a graph's launch cost
  several times more (CUPTI's tracing), so `span_recent_ms()` keeps apart
  the newest `RECENT` durations of each name that no profiler watched: the
  host's time as it runs untraced;
* `device_span(name, device)`: a named stretch of the card's stream
  between two timing events. Inside a CUDA graph's capture the events
  become nodes of the graph, which every replay records again, so the
  span measures the captured step's parts, where a `record_function`
  entered at capture is never replayed. `device_span_ms()` reads the
  newest pair of each name, without waiting.

The spans the port opens, and what reads them:

* `learner.init` (a learner's construction) and, inside it,
  `learner.seed` (the seeded initial parameters, on the CPU);
* `train.step` (a session step's call) and, inside `graphs.Graphed`,
  `graph.stage` (inputs made pinned tensors of the static inputs'
  dtypes), `graph.upload` (the copies to the card), `graph.replay` (the
  graph's launch), and at a capture `graph.warmup` and `graph.capture`;
* `predict.prepare`, `predict.text`, `predict.upload`, `predict.task_id`,
  `predict.forward` and `predict.postprocess` (a request's phases, in
  order); inside the last, `predict.wait` (the host waiting for the card)
  and `nms.greedy_scan` (the host's NMS scan);
* device spans: `graph.<name>` (a captured call, whole), and in the train
  steps `step.forward` (forward and losses), `step.backward` (the
  gradients) and `step.update` (masks, clip, optimizer).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
from torch.profiler import record_function

_LOCK = threading.Lock()
RECENT = 16  # durations of each span kept for `span_recent_ms`
_SPAN_TOTALS: Dict[str, list] = {}  # name -> [seconds, count], over the process
_SPAN_RECENT: Dict[str, collections.deque] = {}  # name -> the newest unwatched seconds
_DEVICE_SPANS: Dict[str, tuple] = {}  # name -> the newest (start, end) events recorded
_CAPTURED: Dict[str, tuple] = {}  # pairs recorded into a graph being captured


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU and CUDA activities; CPU alone without a
    card) and write its Chrome trace, `<worker>.<time>.pt.trace.json`,
    into `logdir`. -> the `torch.profiler.profile` object."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


@contextlib.contextmanager
def span(name: str):
    """A named stretch of host time: a `record_function` range for any
    profiler running, and its seconds and count added to `span_totals()`;
    where no profiler was running at its start, its seconds also go to
    `span_recent_ms()`. Spans nest; each counts its own whole time."""
    with record_function(name):
        watched = torch.autograd._profiler_enabled()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with _LOCK:
                total = _SPAN_TOTALS.setdefault(name, [0.0, 0])
                total[0] += dt
                total[1] += 1
                if not watched:
                    recent = _SPAN_RECENT.get(name)
                    if recent is None:
                        recent = _SPAN_RECENT[name] = collections.deque(maxlen=RECENT)
                    recent.append(dt)


def span_totals() -> Dict[str, Tuple[float, int]]:
    """{name: (seconds, count)} over every span closed in this process."""
    with _LOCK:
        return {k: (v[0], v[1]) for k, v in _SPAN_TOTALS.items()}


def span_recent_ms() -> Dict[str, float]:
    """{name: ms}, the mean of the newest `RECENT` spans of each name that
    no profiler watched (fewer where fewer have closed)."""
    with _LOCK:
        return {k: 1e3 * sum(v) / len(v) for k, v in _SPAN_RECENT.items()}


@contextlib.contextmanager
def device_span(name: str, device):
    """Timing events on the current stream of a CUDA `device` around the
    block; nothing on the CPU. Recorded eagerly, the pair is the newest of
    its name at once; recorded during a capture, it waits in
    `take_captured()` for the graph's owner, which hands it to
    `replayed()` at each replay."""
    if torch.device(device).type != "cuda":
        yield
        return
    start = torch.cuda.Event(enable_timing=True, external=True)
    end = torch.cuda.Event(enable_timing=True, external=True)
    start.record()
    yield  # a block that raises keeps no pair (and records nothing more into a failing capture)
    end.record()
    table = _CAPTURED if torch.cuda.is_current_stream_capturing() else _DEVICE_SPANS
    with _LOCK:
        table[name] = (start, end)


def take_captured() -> Dict[str, tuple]:
    """The device spans recorded into the capture that just ended (a graph
    has not recorded them yet: their times cannot be read before its first
    replay)."""
    with _LOCK:
        out = dict(_CAPTURED)
        _CAPTURED.clear()
    return out


def replayed(pairs: Mapping[str, tuple]) -> None:
    """Make a graph's captured pairs, which its replay just recorded, the
    newest of their names."""
    if pairs:
        with _LOCK:
            _DEVICE_SPANS.update(pairs)


def device_span_ms() -> Dict[str, float]:
    """{name: ms} of the newest pair of each name whose end the card has
    reached; never waits."""
    with _LOCK:
        pairs = dict(_DEVICE_SPANS)
    return {name: start.elapsed_time(end) for name, (start, end) in pairs.items()
            if end.query()}


def _on_card(value) -> bool:
    """Whether a tensor, or a tensor inside a (nested) dict, list or tuple,
    lives on a CUDA device."""
    if isinstance(value, torch.Tensor):
        return value.is_cuda
    if isinstance(value, Mapping):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return any(_on_card(v) for v in value)
    return False


class StepTimer:
    """Wall clock per step; hand `stop` a step output to wait for the card
    before the clock is read."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None) -> float:
        if sync_value is not None and _on_card(sync_value):
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    @property
    def p50(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


def device_memory_stats(device=None) -> dict:
    """One card's memory: `bytes_in_use` (`torch.cuda.memory_allocated`),
    `peak_bytes_in_use` (`torch.cuda.max_memory_allocated`) and
    `bytes_limit` (the card's total, `torch.cuda.mem_get_info`). `device`
    defaults to the current card where there is one. A CPU device gives
    {}, as the JAX function does for a backend without stats."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return {
        "bytes_in_use": torch.cuda.memory_allocated(device),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
        "bytes_limit": torch.cuda.mem_get_info(device)[1],
    }


def compiled_flops(fn: Callable, *args, **kwargs) -> dict:
    """The FLOPs of one call of `fn(*args, **kwargs)`, with the JAX
    function's keys: `flops` is `FlopCounterMode`'s total (2 M N K a
    product, convolutions and attention by their formulas, the backward
    where the call runs one). Two differences from XLA's cost analysis:
    `fn` is executed, not compiled, so its effects happen; and the count
    leaves out every op the counter has no formula for, elementwise ops
    and the port's own CUDA kernels among them. PyTorch has no counterpart
    of XLA's bytes accessed and transcendentals: both are None."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()), "bytes_accessed": None,
            "transcendentals": None}
