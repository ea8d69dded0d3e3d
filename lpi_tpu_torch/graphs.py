"""Capture once, replay many: the port's counterpart of `jax.jit` with
donated state.

`Graphed(fn, inputs, state, name=...)` captures `fn(static_inputs) -> outputs` as one
CUDA graph and replays it on every call:

* it holds static input buffers (`inputs` gives their shapes and dtypes and
  the first values) and copies each call's inputs into them: numpy arrays
  and CPU tensors go through pinned memory, one host-to-device copy each;
* before the capture it runs `fn` a few times on a side stream, as
  `torch.cuda.graph` requires before autograd is captured (and so that
  every lazily built kernel, workspace and cache exists before it);
* those warm-up runs are real runs: a train step moves its parameters and
  its optimizer state. `state` lists every tensor that `fn` updates in
  place; they are copied before the warm-up and copied back, in place,
  after it, so the first replay starts where the first eager step would;
* a call returns the static output tensors, which the next call
  overwrites.

A call's host time falls in three spans (`core.profiling.span`):
`graph.stage` (every input made a pinned tensor of its static buffer's
dtype), `graph.upload` (the copies into the static buffers, in the same
order) and `graph.replay` (the graph's launch, which can hold the host
until earlier work on the card has drained). The construction's falls in
`graph.warmup` and `graph.capture`. The captured `fn` runs inside the
device span `graph.<name>`, which every replay records:
`core.profiling.device_span_ms()` reads the card's time of the newest
replay.

Whatever `fn` reads besides its inputs (parameters, optimizer moments,
0-d device scalars such as a task id or a learning rate) it reads at the
addresses it had at capture: callers write new values into those tensors
in place before a replay, never rebind them. Host-side Python in `fn`
(counters, branches, launch counters) runs only during the warm-up and the
capture.

Only the caller's device decides whether to capture: `captures(device)` is
true on a CUDA device, and there a capture that fails raises. On the CPU
the callers run `fn` eagerly. Nothing here touches CUDA when imported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Sequence

import numpy as np
import torch

from lpi_tpu_torch.core.profiling import device_span, replayed, span, take_captured

WARMUP = 3  # eager runs before the capture, as `torch.cuda.graphs`' examples make


def captures(device) -> bool:
    """Whether work on `device` is captured and replayed (CUDA) or run
    eagerly (the CPU)."""
    return torch.device(device).type == "cuda"


def _host(value, dtype: torch.dtype) -> torch.Tensor:
    """A numpy array or CPU tensor as a pinned CPU tensor of `dtype`."""
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
    return t.to(dtype).pin_memory()


class Graphed:
    """`fn` captured over static copies of `inputs`; `state` is restored
    after the warm-up. `self(inputs)` copies `inputs` in, replays, and
    returns the static outputs. `name` labels the graph's device span."""

    def __init__(self, fn: Callable[[Dict[str, torch.Tensor]], Any],
                 inputs: Mapping[str, torch.Tensor], state: Sequence[torch.Tensor] = (),
                 warmup: int = WARMUP, *, name: str):
        first = next(iter(inputs.values()))
        if first.device.type != "cuda":
            raise ValueError(f"capture needs CUDA tensors, got {first.device}")
        self.inputs = {k: torch.empty_like(v) for k, v in inputs.items()}
        self._fill(inputs)
        with span("graph.warmup"):
            with torch.no_grad():
                saved = [t.detach().clone() for t in state]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(warmup):
                    fn(self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            with torch.no_grad():
                for t, s in zip(state, saved):
                    t.copy_(s)
            del saved
        with span("graph.capture"):
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                with device_span(f"graph.{name}", first.device):
                    self.outputs = fn(self.inputs)
        self._device_spans = take_captured()

    def _fill(self, inputs: Mapping[str, Any]) -> None:
        """Every input staged (host ones pinned, in their buffer's dtype),
        then every one copied into its static buffer."""
        with span("graph.stage"):
            staged = []
            for k, dst in self.inputs.items():
                src = inputs[k]
                if not (isinstance(src, torch.Tensor) and src.device.type == "cuda"):
                    src = _host(src, dst.dtype)
                staged.append(src)
        with span("graph.upload"):
            for dst, src in zip(self.inputs.values(), staged):
                dst.copy_(src, non_blocking=True)

    def __call__(self, inputs: Mapping[str, Any]):
        self._fill(inputs)
        with span("graph.replay"):
            self.graph.replay()
        replayed(self._device_spans)
        return self.outputs
