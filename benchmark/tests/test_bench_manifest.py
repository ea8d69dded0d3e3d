"""BENCHMARK.json against the benchmark's contract, and the harness as data:
every name resolves to its files, and a cell, a configuration and a metric
added as files alone are picked up with no edit."""

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.manifest import Manifest
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def one_line(text, most=200):
    return 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and all(
        re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.endswith("_torch")
        for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32 and all(one_line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = {}
    for kind, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                       ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for e in SPEC[kind]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and one_line(e["why"])
            names.setdefault(kind, set()).add(e["name"])
    assert len(names["configs"]) == len(SPEC["configs"])
    assert len(names["workloads"]) == len(SPEC["workloads"])
    for c in SPEC["configs"]:
        assert one_line(c["source"]) and c["source"].startswith("https://")
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert w["config"] in names["configs"] and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source", "layer",
                                          "moves"}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"]) and "bound" not in m
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    m = Manifest()
    cells = [w["name"] for w in SPEC["workloads"]]
    for cell in cells:
        e2e = {x["name"] for x in m.end_to_end(cell)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert m.per_layer(cell), cell
    for metric in SPEC["per_layer"]:
        for cell in metric.get("workloads", cells):
            assert metric["moves"] in {x["name"] for x in m.end_to_end(cell)}, (metric, cell)
        if "mfu" in metric["name"] or metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"


def test_every_name_resolves_to_its_files():
    m = Manifest()
    for w in SPEC["workloads"]:
        cell = m.cell(w["name"])
        assert cell["conf"]["name"] == w["config"]
        assert m.family(cell["conf"]["family"]).Trainer or True
        assert hasattr(m.driver(cell["cell_file"]["driver"]), "run")
        assert m.generator(cell["traffic_params"]["generator"])
        assert set(cell["cell_file"]["limits"])
    for metric in SPEC["per_layer"]:
        assert hasattr(m.metric(metric["name"]), "read")
    for c in SPEC["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and conf["name"] == c["name"]


def test_files_under_paths_are_named_from_name_characters():
    for p in SPEC["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_a_cell_a_configuration_and_a_metric_added_as_files_alone(tmp_path):
    """In a copy: a second retrieval configuration, its traffic, its cell and a
    new per-layer metric, each a new file and a new entry; the harness runs
    the cell and reports the metric with no edit to any file it had."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = tmp_path / "benchmark"
    conf = json.loads((bench / "configs" / "clip-vitb16-lpi.json").read_text())
    conf["name"] = "clip-vitb16-lpi-b"
    (bench / "configs" / "clip-vitb16-lpi-b.json").write_text(json.dumps(conf))
    traffic = json.loads((bench / "traffic" / "coco-pairs-b64.json").read_text())
    (bench / "traffic" / "coco-pairs-b32.json").write_text(json.dumps({**traffic, "batch": 32}))
    shutil.copy(bench / "workloads" / "retr-train-b64.json", bench / "workloads" / "retr-b-b32.json")
    (bench / "metrics" / "steps_traced.train.py").write_text(
        "def read(ctx):\n    return ctx.get('traced_steps')\n")
    spec["configs"].append({"name": "clip-vitb16-lpi-b", "source": "https://example.org/b",
                           "file": "benchmark/configs/clip-vitb16-lpi-b.json", "reduced": [],
                           "why": "a second configuration"})
    spec["workloads"].append({"name": "retr-b-b32", "config": "clip-vitb16-lpi-b",
                              "traffic": "coco-pairs-b32", "chips": 1, "why": "added"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "retr-train-b64" in m["workloads"]:
            m["workloads"].append("retr-b-b32")
    spec["per_layer"].append({"name": "steps_traced.train", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "learners and graphs.py",
                              "moves": "train_samples_per_s", "workloads": ["retr-b-b32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    before = {p.name for p in (ROOT / "benchmark").rglob("*") if p.is_file()}

    out = tiny.run("retr-b-b32", tiny.manifest("float32", bench), trace=1)
    assert out["correct"] and out["metrics"]["steps_traced.train"]["value"] == 2
    assert {p.name for p in (ROOT / "benchmark").rglob("*") if p.is_file()} == before


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_runs_on_the_cpu_at_toy_widths(cell):
    """The whole run, the look for a card skipped, at toy widths in fp32, so
    that the limits of the cell hold it: its end-to-end metrics, its device
    block and its checks, each with its limit, the checks last."""
    out = tiny.run(cell, tiny.manifest("float32"))
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert {m["name"] for m in Manifest().end_to_end(cell)} == set(out["metrics"])
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
