"""The port's spans (`lpi_tpu_torch.core.profiling`): host spans that any
`torch.profiler` run sees and whose seconds add up in `span_totals()`,
and device spans, timing events that a CUDA graph's capture keeps and
every replay records again.

On the CPU: a span nests, counts and shows in a Chrome trace; a request's
phases appear once each, in order; a learner's step and construction
record theirs; a device span records nothing. The `gpu` tests read device
spans after a replay and the staging split of a captured call. The file
imports neither JAX nor the JAX package, so that it runs on a machine with
only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_tracing.py
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lpi_tpu_torch import config as tc
from lpi_tpu_torch import graphs
from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
from lpi_tpu_torch.continual.learner import RetrievalLearner
from lpi_tpu_torch.core import profiling
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
from lpi_tpu_torch.data.grounding import synthetic_grounding_task
from lpi_tpu_torch.ops import nms
from lpi_tpu_torch.ops.boxes import box_iou
from lpi_tpu_torch.serve.predictor import GroundingPredictor

torch.set_num_threads(1)
PHASES = ["predict.prepare", "predict.text", "predict.upload", "predict.task_id",
          "predict.forward", "predict.postprocess"]


def _grounding_cfg():
    return tc.GroundingConfig(
        swin=tc.SwinConfig(patch_size=4, embed_dim=8, depths=(2, 2, 2, 2),
                           num_heads=(1, 2, 2, 2), window_size=4),
        bert=tc.BertConfig(vocab_size=512, hidden_size=16, num_layers=8, num_heads=2,
                           intermediate_size=32, max_position_embeddings=32,
                           max_query_len=16),
        dyhead=tc.DyHeadConfig(num_convs=1, channels=32, max_tokens=16),
        atss=tc.ATSSConfig(anchor_sizes=(8, 16, 32, 64, 128),
                           anchor_strides=(4, 8, 16, 32, 64), pre_nms_top_n=50,
                           fpn_post_nms_top_n=10),
        lpi=tc.LPIPromptConfig(prompt_length=4, prompt_depth=6, prompt_rank=2,
                               interact_rank=2, interact_depth=6),
        total_tasks=3, epochs_per_task=1, batch_size=2, max_boxes=4,
        image_size=64, num_key_clusters=2, dtype="float32")


def _retrieval_cfg():
    return tc.RetrievalConfig(
        clip=tc.CLIPConfig(image_resolution=32, patch_size=8, vision_width=64,
                           vision_layers=2, vision_heads=4, text_width=64, text_layers=2,
                           text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
                           n_ctx=4),
        lpi=tc.LPIPromptConfig(prompt_length=4, prompt_depth=2, prompt_rank=2),
        total_sessions=3, epochs=1, batch_size=4, lr=0.05, visual_dim=64, textual_dim=64,
        num_key_clusters=2, dtype="float32")


def _learner(kind: str, device="cpu"):
    gen = torch.Generator().manual_seed(1)
    if kind == "grounding":
        return GroundingLearner(_grounding_cfg(), generator=gen, device=device)
    return RetrievalLearner(_retrieval_cfg(), generator=gen, device=device)


def _batch(kind: str):
    if kind == "grounding":
        tok = BertTokenizer(max_len=16, vocab_size=512)
        return next(synthetic_grounding_task(1, num_samples=2, image_size=64,
                                             tokenizer=tok).batches(2))
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 1000, size=(4, 77))
    ids[:, 10] = 49407  # the end of text, the largest id: the text tower's pooled token
    return {"images": rng.rand(4, 32, 32, 3).astype(np.float32), "token_ids": ids}


def _step(learner, kind: str):
    if kind == "grounding":
        return learner.make_step(1, steps_per_epoch=1, epochs=1)
    return learner.make_train_step(1, steps_per_epoch=1, epochs=1)


def _delta(before: dict, after: dict, name: str):
    s0, n0 = before.get(name, (0.0, 0))
    s1, n1 = after.get(name, (0.0, 0))
    return s1 - s0, n1 - n0


def _annotations(prof, tmp_path) -> list:
    """[(name, start us, end us)] of the user annotations in the profile's
    Chrome trace, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                  key=lambda e: e[1])


def _predictor():
    learner = _learner("grounding")
    return GroundingPredictor(learner.model, tokenizer=BertTokenizer(max_len=16, vocab_size=512),
                              image_size=64, score_thresh=0.0, device="cpu")


IMAGE = (np.random.RandomState(3).rand(48, 80, 3) * 255).astype(np.uint8)


# ---- host spans -----------------------------------------------------------

def test_span_nests_counts_and_shows_in_a_profiler_trace(tmp_path):
    """Each span closed adds one count and its seconds; nested spans each
    count their whole time; both are user annotations of the trace, the
    inner inside the outer."""
    before = profiling.span_totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("tracing_test.outer"):
            time.sleep(0.002)
            with profiling.span("tracing_test.inner"):
                time.sleep(0.01)
    after = profiling.span_totals()
    outer, n_outer = _delta(before, after, "tracing_test.outer")
    inner, n_inner = _delta(before, after, "tracing_test.inner")
    assert n_outer == 1 and n_inner == 1
    assert inner >= 0.01 and outer >= inner + 0.002
    spans = {n: (a, b) for n, a, b in _annotations(prof, tmp_path)}
    (oa, ob), (ia, ib) = spans["tracing_test.outer"], spans["tracing_test.inner"]
    assert oa <= ia and ib <= ob


def test_span_counts_a_block_that_raises():
    before = profiling.span_totals()
    with pytest.raises(KeyError):
        with profiling.span("tracing_test.raises"):
            raise KeyError("x")
    assert _delta(before, profiling.span_totals(), "tracing_test.raises")[1] == 1


def test_span_recent_keeps_the_newest_unwatched_durations(monkeypatch):
    """`span_recent_ms` means the newest `RECENT` spans of a name that no
    profiler watched: a profiled one is left out, and older ones fall off."""
    monkeypatch.setattr(profiling, "_SPAN_RECENT", {})
    with profiling.span("tracing_test.recent"):
        time.sleep(0.02)
    assert profiling.span_recent_ms()["tracing_test.recent"] >= 20.0
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("tracing_test.recent"):
            time.sleep(0.2)
    assert profiling.span_recent_ms()["tracing_test.recent"] < 200.0
    for _ in range(profiling.RECENT):
        with profiling.span("tracing_test.recent"):
            pass
    assert profiling.span_recent_ms()["tracing_test.recent"] < 1.0


def test_device_span_records_nothing_on_the_cpu():
    """On the CPU the block runs and no pair is kept, eagerly or as if
    captured."""
    before = profiling.device_span_ms()
    ran = []
    with profiling.device_span("tracing_test.device", "cpu"):
        ran.append(1)
    assert ran == [1]
    assert profiling.device_span_ms() == before
    assert "tracing_test.device" not in profiling.device_span_ms()
    assert profiling.take_captured() == {}


# ---- the request ----------------------------------------------------------

def test_predict_phases_in_order_once_each_and_answers_unchanged(tmp_path):
    """One request under the profiler: the six phases once each, in order
    and without overlap, the host NMS scan inside the postprocess; the
    answers equal, bit for bit, the same request with no profiler."""
    predictor = _predictor()
    caption = "a red car on the left side"
    plain = predictor.predict(IMAGE, caption)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = predictor.predict(IMAGE, caption)
    for k in ("boxes", "scores"):
        assert np.array_equal(plain[k], traced[k]), k
    assert plain["entities"] == traced["entities"] and plain["task_id"] == traced["task_id"]
    spans = _annotations(prof, tmp_path)
    phases = [s for s in spans if s[0].startswith("predict.")]
    assert [n for n, _, _ in phases] == PHASES  # no predict.wait: the CPU has nothing to wait for
    for (_, _, end), (_, start, _) in zip(phases, phases[1:]):
        assert end <= start
    _, pa, pb = phases[-1]
    scans = [(a, b) for n, a, b in spans if n == "nms.greedy_scan"]
    assert scans and all(pa <= a and b <= pb for a, b in scans)


def test_predict_classes_runs_the_same_phases_but_the_task_id(tmp_path):
    predictor = _predictor()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        predictor.predict_classes(IMAGE, ["car", "tree"])
    names = [n for n, _, _ in _annotations(prof, tmp_path) if n.startswith("predict.")]
    assert names == [p for p in PHASES if p != "predict.task_id"]


def test_predict_phases_add_to_the_totals_without_a_profiler():
    predictor = _predictor()
    before = profiling.span_totals()
    predictor.predict(IMAGE, "a red car on the left side")
    after = profiling.span_totals()
    for name in PHASES:
        seconds, count = _delta(before, after, name)
        assert count == 1 and seconds > 0, name


@pytest.mark.parametrize("labels", [False, True])
def test_nms_scan_span_times_the_host_scan_alone(labels):
    """The NMS keep mask is the greedy scan's, and the scan's span opens
    once a call."""
    rng = np.random.RandomState(1)
    xy = rng.rand(40, 2) * 50
    boxes = torch.from_numpy(np.concatenate([xy, xy + 5 + rng.rand(40, 2) * 20], 1)).float()
    scores = torch.from_numpy(rng.rand(40)).float()
    before = profiling.span_totals()
    if labels:
        lab = torch.from_numpy(rng.randint(0, 3, 40))
        keep = nms.ml_nms_mask(boxes, scores, lab, 0.5)
    else:
        lab = None
        keep = nms.nms_mask(boxes, scores, 0.5)
    assert _delta(before, profiling.span_totals(), "nms.greedy_scan")[1] == 1
    order = np.argsort(-scores.numpy(), kind="stable")
    b = boxes[order]
    iou = box_iou(b, b)
    if lab is not None:
        iou = iou * (lab[order][:, None] == lab[order][None, :])
    want = np.zeros(40, bool)
    want[order] = nms.greedy_scan((iou > 0.5).numpy(), np.ones(40, bool))
    assert np.array_equal(keep.numpy(), want)


# ---- the learners ---------------------------------------------------------

@pytest.mark.parametrize("kind", ["grounding", "retrieval"])
def test_building_a_learner_adds_one_init_and_one_seed(kind):
    before = profiling.span_totals()
    _learner(kind)
    after = profiling.span_totals()
    init, n_init = _delta(before, after, "learner.init")
    seed, n_seed = _delta(before, after, "learner.seed")
    assert n_init == 1 and n_seed == 1
    assert 0 < seed <= init


@pytest.mark.parametrize("kind", ["grounding", "retrieval"])
def test_an_eager_step_records_train_step(kind, tmp_path):
    """An eager CPU step: one `train.step` in the totals and in a profile,
    no graph span (the CPU never captures) and no device span."""
    learner = _learner(kind)
    step = _step(learner, kind)
    batch = _batch(kind)
    devices = profiling.device_span_ms()
    before = profiling.span_totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step(batch)
    assert all(torch.isfinite(v).all() for v in out.values())
    after = profiling.span_totals()
    assert _delta(before, after, "train.step")[1] == 1
    assert not any(_delta(before, after, n)[1] for n in after if n.startswith("graph."))
    assert [n for n, _, _ in _annotations(prof, tmp_path)] == ["train.step"]
    assert profiling.device_span_ms() == devices


# ---- on the card ----------------------------------------------------------

@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device spans and graph capture exist only there")
    return torch.device("cuda")


@pytest.mark.gpu
def test_device_spans_inside_a_capture_read_after_a_replay(card):
    """Two matmul chains, each in a device span, captured in one graph:
    after a replay and a synchronise both read > 0 ms, and together no more
    than the graph's own span and 5%."""
    w = torch.randn(1024, 1024, device=card)

    def fn(b):
        out = {}
        for name in ("first", "second"):
            with profiling.device_span(f"tracing_test.{name}", card):
                out[name] = (b["x"] @ w) @ w
        return out

    g = graphs.Graphed(fn, {"x": torch.randn(1024, 1024, device=card)},
                       name="tracing_test_pair")
    g({"x": np.random.RandomState(0).rand(1024, 1024).astype(np.float32)})
    torch.cuda.synchronize()
    ms = profiling.device_span_ms()
    first, second = ms["tracing_test.first"], ms["tracing_test.second"]
    assert first > 0 and second > 0
    assert first + second <= 1.05 * ms["graph.tracing_test_pair"]


@pytest.mark.gpu
def test_a_profiled_graph_call_holds_stage_upload_and_replay(card, tmp_path):
    """One profiled call: `graph.stage`, `graph.upload` and `graph.replay`
    once each, in order, inside the caller's span."""
    g = graphs.Graphed(lambda b: {"y": b["x"] * 2}, {"x": torch.zeros(256, device=card)},
                       name="tracing_test_double")
    x = np.arange(256, dtype=np.float32)
    g({"x": x})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with profiling.span("tracing_test.caller"):
            out = g({"x": x})
        torch.cuda.synchronize()
    assert torch.equal(out["y"].cpu(), torch.from_numpy(x) * 2)
    spans = _annotations(prof, tmp_path)
    (ca, cb), = [(a, b) for n, a, b in spans if n == "tracing_test.caller"]
    inner = [(n, a, b) for n, a, b in spans if n.startswith("graph.")]
    assert [n for n, _, _ in inner] == ["graph.stage", "graph.upload", "graph.replay"]
    assert all(ca <= a and b <= cb for _, a, b in inner)


@pytest.mark.gpu
def test_a_captured_step_records_its_three_device_spans(card):
    """Two captured retrieval steps at toy widths: forward, backward and
    update read > 0 ms after the second, and sum to no more than the
    captured step's span and 5%."""
    learner = _learner("retrieval", device=card)
    step = _step(learner, "retrieval")
    batch = _batch("retrieval")
    step(batch)
    step(batch)
    torch.cuda.synchronize()
    ms = profiling.device_span_ms()
    parts = [ms[f"step.{p}"] for p in ("forward", "backward", "update")]
    assert all(p > 0 for p in parts)
    assert sum(parts) <= 1.05 * ms["graph.train"]
