"""The per-layer metrics that read the program's own spans: the host spans'
untraced means, the device spans and the span totals from seeded tables,
nothing where a span is missing (or where the program keeps no such table,
as before it had one), and a traced run of each cell on the CPU at toy
widths with every entry in place."""

import math
import time

import pytest
import torch

from benchmark.manifest import Manifest
from benchmark.tests import tiny
from benchmark.trace import WINDOW, TraceData
from lpi_tpu_torch.core import profiling

HOST = [("learner_call_ms.train", "train", "train.step"),
        ("stage_ms.train", "train", "graph.stage"),
        ("upload_ms.train", "train", "graph.upload"),
        ("replay_ms.train", "train", "graph.replay"),
        ("text_ms.serve", "serve", "predict.text"),
        ("wait_ms.serve", "serve", "predict.wait")]
DEVICE = [("forward_device_ms.train", "train", "step.forward"),
          ("backward_device_ms.train", "train", "step.backward"),
          ("update_device_ms.train", "train", "step.update"),
          ("forward_device_ms.serve", "serve", "graph.forward")]
NEW = [m for m, _, _ in HOST + DEVICE] + ["init_s.setup", "capture_s.setup"]


def _metric(name):
    return Manifest().metric(name)


def _trace(spans):
    """A sub-window of 100 ms holding `spans` [(name, start ms, end ms)]."""
    inside = [(n, a * 1e3, b * 1e3) for n, a, b in spans]
    return TraceData([("k", 0.0, 1e3)], [(WINDOW, 0.0, 100e3)] + inside)


def _seed(monkeypatch, totals=None, device=None, recent=None):
    monkeypatch.setattr(profiling, "span_totals", lambda: dict(totals or {}))
    monkeypatch.setattr(profiling, "device_span_ms", lambda: dict(device or {}))
    monkeypatch.setattr(profiling, "span_recent_ms", lambda: dict(recent or {}))


@pytest.mark.parametrize("metric,kind,span", HOST)
def test_a_host_span_metric_is_its_untraced_mean(metric, kind, span, monkeypatch):
    """The untraced mean, whatever the traced sub-window holds of the span."""
    m = _metric(metric)
    trace = _trace([(span, 10.0, 30.0), ("other.span", 50.0, 90.0)])
    _seed(monkeypatch, recent={span: 3.0, "other.span": 40.0})
    assert m.read({"kind": kind, "trace": trace}) == 3.0
    assert m.read({"kind": kind, "trace": None}) == 3.0
    other = "serve" if kind == "train" else "train"
    assert m.read({"kind": other, "trace": trace}) is None
    _seed(monkeypatch, recent={"other.span": 40.0})
    assert m.read({"kind": kind, "trace": trace}) is None


@pytest.mark.parametrize("metric,kind,span", HOST)
def test_a_host_span_metric_leaves_out_the_profiled_spans(metric, kind, span, monkeypatch):
    """Through the program's own table (a fresh one): a span closed under a
    profiler adds nothing to what the metric reads, one closed without
    does."""
    monkeypatch.setattr(profiling, "_SPAN_RECENT", {})
    m = _metric(metric)
    for _ in range(profiling.RECENT):
        with profiling.span(span):
            pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span(span):
            time.sleep(0.02)
    assert m.read({"kind": kind, "trace": None}) < 1.0
    with profiling.span(span):
        time.sleep(0.02)
    assert m.read({"kind": kind, "trace": None}) >= 20.0 / profiling.RECENT


@pytest.mark.parametrize("metric,kind,span", DEVICE)
def test_a_device_span_metric_reads_its_newest_pair(metric, kind, span, monkeypatch):
    m = _metric(metric)
    _seed(monkeypatch, device={span: 12.5, "graph.other": 99.0})
    assert m.read({"kind": kind}) == 12.5
    other = "serve" if kind == "train" else "train"
    assert m.read({"kind": other}) is None
    _seed(monkeypatch, device={"graph.other": 99.0})
    assert m.read({"kind": kind}) is None


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_the_setup_metrics_read_the_span_totals(kind, monkeypatch):
    init, capture = _metric("init_s.setup"), _metric("capture_s.setup")
    _seed(monkeypatch, totals={"learner.init": (7.25, 1), "learner.seed": (6.0, 1),
                               "graph.warmup": (2.5, 2), "graph.capture": (0.75, 2),
                               "graph.replay": (9.0, 40)})
    assert init.read({"kind": kind}) == 7.25
    assert capture.read({"kind": kind}) == 3.25
    _seed(monkeypatch, totals={"graph.warmup": (2.5, 2)})
    assert init.read({"kind": kind}) is None
    assert capture.read({"kind": kind}) == 2.5
    _seed(monkeypatch, totals={"train.step": (1.0, 3)})
    assert capture.read({"kind": kind}) is None


@pytest.mark.parametrize("metric", NEW)
def test_without_the_programs_tables_a_metric_reads_nothing(metric, monkeypatch):
    """A program without `span_totals`, `span_recent_ms` and
    `device_span_ms` (as before the spans): nothing, and no error."""
    monkeypatch.delattr(profiling, "span_totals")
    monkeypatch.delattr(profiling, "span_recent_ms")
    monkeypatch.delattr(profiling, "device_span_ms")
    for kind in ("train", "serve"):
        assert _metric(metric).read({"kind": kind, "trace": _trace([])}) is None


def test_the_entries_name_the_files_and_their_cells():
    m = Manifest()
    entries = {e["name"]: e for e in m.spec["per_layer"]}
    assert {e["name"] for e in m.spec["per_layer"][-len(NEW):]} == set(NEW)
    for name in NEW:
        assert entries[name]["source"] == "program_span" and hasattr(m.metric(name), "read")
    assert entries["init_s.setup"]["workloads"] == [w["name"] for w in m.spec["workloads"]]


@pytest.mark.parametrize("cell", [w["name"] for w in Manifest().spec["workloads"]])
def test_a_traced_run_on_the_cpu_reads_the_host_spans(cell):
    """At toy widths on the CPU, where the step runs eagerly: the learner's
    call (or the request's text) and its construction read finite values;
    the graph's spans, the device spans, the captures and the wait, which
    the CPU does not have, read nothing."""
    out = tiny.run(cell, tiny.manifest("float32"), trace=1)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    found = ["init_s.setup",
             "text_ms.serve" if cell.endswith("serve-b1") else "learner_call_ms.train"]
    for name in found:
        assert math.isfinite(got[name]["value"]) and got[name]["value"] > 0, name
    assert set(NEW) & set(got) == set(found)
