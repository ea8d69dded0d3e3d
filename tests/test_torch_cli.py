"""The port's command line on the CPU (`python -m lpi_tpu_torch.cli.main
--platform cpu ...`), at tiny widths given by a `--config` json.

`train` and `train-grounding` run two sessions each on synthetic data and
save their checkpoints and result files; `eval`, `eval-all` (both kinds)
and `predict` then restore from those checkpoints in fresh learners and
must give exactly what the training run recorded or computed; `report`
gives the JAX package's `get_res` on the same file. The result files carry
the JAX command line's schema. The commands whose modules are not ported
exit non-zero naming their ROADMAP item; without a card the default
platform refuses to run.
"""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from lpi_tpu.eval.reshandle import get_res as j_get_res
from lpi_tpu_torch.bench import deterministic
from lpi_tpu_torch.cli import main as cli
from lpi_tpu_torch.config import load_config
from lpi_tpu_torch.continual import grounding_learner as gl
from lpi_tpu_torch.continual.common import load_in_place
from lpi_tpu_torch.core.checkpoint import SessionCheckpointer
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
from lpi_tpu_torch.data.grounding import synthetic_grounding_task
from lpi_tpu_torch.eval.reshandle import get_res
from lpi_tpu_torch.models.clip.convert import convert_openai_clip, synthetic_state_dict
from lpi_tpu_torch.serve.predictor import GroundingPredictor

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = {
    "retrieval": {
        "clip": {"image_resolution": 32, "patch_size": 8, "vision_width": 64, "vision_layers": 2,
                 "vision_heads": 4, "text_width": 64, "text_layers": 2, "text_heads": 4,
                 "embed_dim": 32, "n_ctx": 4},
        "lpi": {"prompt_length": 4, "prompt_depth": 2, "prompt_rank": 2},
        "total_sessions": 3, "epochs": 1, "batch_size": 8, "visual_dim": 64,
        "textual_dim": 64, "num_key_clusters": 2, "dtype": "float32"},
    "grounding": {
        "swin": {"patch_size": 4, "embed_dim": 8, "depths": [2, 2, 2, 2],
                 "num_heads": [1, 2, 2, 2], "window_size": 4},
        "bert": {"vocab_size": 512, "hidden_size": 16, "num_layers": 8, "num_heads": 2,
                 "intermediate_size": 32, "max_position_embeddings": 32, "max_query_len": 16},
        "dyhead": {"num_convs": 1, "channels": 16, "max_tokens": 16},
        "atss": {"anchor_sizes": [32, 64, 128, 256, 512], "anchor_strides": [4, 8, 16, 32, 64],
                 "pre_nms_top_n": 50, "fpn_post_nms_top_n": 10, "inference_thresh": 0.0},
        "lpi": {"prompt_length": 4, "prompt_depth": 6, "prompt_rank": 2, "interact_rank": 2,
                "interact_depth": 6},
        "fpn_use_gn": True, "total_tasks": 3, "batch_size": 4, "max_boxes": 4,
        "image_size": 64, "num_key_clusters": 2, "dtype": "float32"},
}


@pytest.fixture(scope="module")
def config(tmp_path_factory):
    path = tmp_path_factory.mktemp("config") / "tiny.json"
    path.write_text(json.dumps(CONFIG))
    return str(path)


@pytest.fixture(scope="module")
def config99(tmp_path_factory):
    """The same config with both learners' initial parameters seeded 99, not
    as the training commands seeded them: a learner built from it gives the
    writer's numbers only through what it restores."""
    path = tmp_path_factory.mktemp("config") / "tiny99.json"
    path.write_text(json.dumps({k: dict(v, seed=99) for k, v in CONFIG.items()}))
    return str(path)


def _run(*argv):
    return cli.main(["--platform", "cpu", *argv])


@contextlib.contextmanager
def _head_outputs():
    """Copies of the head outputs (box regression, centerness, token logits)
    of every eval batch that `GroundingLearner.evaluate` postprocesses, in
    order."""
    seen, post = [], gl.atss_postprocess_batch

    def record(anchors, level_counts, bbox_pred, centerness, dot_logits, *a, **kw):
        seen.append([t.detach().clone() for t in (bbox_pred, centerness, dot_logits)])
        return post(anchors, level_counts, bbox_pred, centerness, dot_logits, *a, **kw)

    gl.atss_postprocess_batch = record
    try:
        yield seen
    finally:
        gl.atss_postprocess_batch = post


def _same_heads(got, want) -> bool:
    return len(got) == len(want) > 0 and all(
        torch.equal(g, w) for gb, wb in zip(got, want) for g, w in zip(gb, wb))


# ---- retrieval ---------------------------------------------------------------
@pytest.fixture(scope="module")
def retrieval(config, tmp_path_factory):
    """`train` with a converted CLIP checkpoint and a task-similarity file."""
    d = tmp_path_factory.mktemp("retrieval")
    clip = synthetic_state_dict(load_config(config).retrieval.clip, seed=4)
    torch.save({k: torch.from_numpy(v) for k, v in clip.items()}, d / "clip.pt")
    np.savetxt(d / "sim.txt", np.array([[1.0, 0.5, 0.1], [0.5, 1.0, 0.2], [0.1, 0.2, 1.0]]))
    path, learner = _run("train", "--synthetic", "--sessions", "2", "--epochs", "1",
                         "--config", config, "--clip-ckpt", str(d / "clip.pt"),
                         "--task-sim", str(d / "sim.txt"), "--output-dir", str(d / "res"),
                         "--checkpoint-dir", str(d / "ckpt"))
    with open(path) as f:
        results = json.load(f)
    return d, path, learner, results, convert_openai_clip(clip)


def test_train_writes_the_reference_schema_and_checkpoints(retrieval):
    d, path, learner, results, clip = retrieval
    assert list(results) == ["0", "1"]
    for s, res in results.items():
        assert set(res) == {"mscoco", "summary", "task_id_accuracy"}
        assert set(res["mscoco"]) == {"i2t", "t2i"}
        assert all(set(res["mscoco"][k]) == {str(t) for t in range(int(s) + 1)}
                   and all(len(v) == 3 for v in res["mscoco"][k].values())
                   for k in ("i2t", "t2i"))
        assert set(res["task_id_accuracy"]) == {"visual", "textual"}
        assert "r_mean" in res["summary"]
        with open(d / "ckpt" / f"session_{s}_results.json") as f:
            assert json.load(f) == res
    assert sorted(os.listdir(d / "ckpt")) == ["base", "latest", "session_0",
                                              "session_0_results.json", "session_1",
                                              "session_1_results.json"]
    assert (d / "ckpt" / "latest").read_text() == "1"
    assert os.path.exists(d / "res" / "metrics.jsonl") and os.path.exists(d / "res" / "log.txt")
    for name, v in clip.items():  # the towers stay the converted checkpoint's
        assert torch.equal(learner.frozen[name], v), name
    assert learner.task_relation.tolist() == [[1, 1, 0], [1, 1, 0], [0, 0, 1]]


def test_eval_and_eval_all_reproduce_the_training_run(retrieval, config99, capsys):
    d, _, _, results, _ = retrieval
    res = _run("eval", "--synthetic", "--config", config99, "--checkpoint-dir", str(d / "ckpt"),
               "--session", "1")
    assert json.loads(json.dumps(res["summary"])) == results["1"]["summary"]
    assert res["task_id_accuracy"] == results["1"]["task_id_accuracy"]
    assert json.loads(json.dumps({"i2t": res["i2t"], "t2i": res["t2i"]}, default=float)) == \
        results["1"]["mscoco"]
    out = _run("eval-all", "--synthetic", "--config", config99, "--checkpoint-dir",
               str(d / "ckpt"), "--output", str(d / "all.json"))
    assert sorted(out) == [0, 1]
    for s in out:
        assert out[s]["summary"] == results[str(s)]["summary"]
        assert out[s]["task_id_accuracy"] == results[str(s)]["task_id_accuracy"]
    with open(d / "all.json") as f:
        assert json.load(f) == json.loads(json.dumps(out, default=float))
    printed = capsys.readouterr().out
    assert '"session": 1' in printed


def test_report_matches_the_jax_package(retrieval, capsys):
    _, path, _, _, _ = retrieval
    for metric in ("i2t", "t2i"):
        got = cli.main(["report", path, "--metric", metric])
        assert got == get_res(path, metric=metric) == j_get_res(path, metric=metric)
    assert json.loads(capsys.readouterr().out.split("}\n{")[0] + "}") == \
        j_get_res(path, metric="i2t")
    assert get_res(path, num_sessions=1) == j_get_res(path, num_sessions=1)


# ---- grounding ---------------------------------------------------------------
@pytest.fixture(scope="module")
def grounding(config, tmp_path_factory):
    d = tmp_path_factory.mktemp("grounding")
    with _head_outputs() as heads:
        path, learner = _run("train-grounding", "--synthetic", "--tasks", "2", "--epochs", "1",
                             "--config", config, "--output-dir", str(d / "res"),
                             "--checkpoint-dir", str(d / "ckpt"))
    with open(path) as f:
        results = json.load(f)
    return d, path, learner, results, heads


def test_train_grounding_writes_the_reference_schema(grounding):
    d, path, learner, results, _ = grounding
    assert os.path.basename(path) == "res_grounding.json"
    assert list(results) == ["0", "1"]
    for s, res in results.items():
        assert set(res) == {"per_task", "overall", "task_id_accuracy"}
        assert set(res["per_task"]) == {str(t) for t in range(int(s) + 1)}
        assert len(res["overall"]) == 3 and 0 <= res["task_id_accuracy"] <= 1
        with open(d / "ckpt" / f"session_{s}_results.json") as f:
            assert json.load(f) == res
    assert (d / "ckpt" / "latest").read_text() == "1"
    assert learner.keys.valid.tolist() == [True, True, False]


def test_eval_all_grounding_reproduces_the_training_run(grounding, config99):
    """In a learner seeded otherwise than the writer: the head outputs of
    every eval batch in bits, then P@1/5/10 and the task-ID accuracy."""
    d, _, _, results, trained = grounding
    with _head_outputs() as again:
        out = _run("eval-all", "--grounding", "--synthetic", "--config", config99,
                   "--checkpoint-dir", str(d / "ckpt"))
    assert _same_heads(again, trained)
    assert sorted(out) == [0, 1]
    for s in out:
        want = results[str(s)]
        assert [float(v) for v in out[s]["overall"]] == want["overall"]
        assert {t: [float(v) for v in p] for t, p in out[s]["per_task"].items()} == \
            want["per_task"]
        assert out[s]["task_id_accuracy"] == want["task_id_accuracy"]


def test_predict_from_the_checkpoint_equals_the_training_learner(grounding, config, config99,
                                                                  capsys):
    d, _, learner, _, _ = grounding
    image = np.random.RandomState(2).randint(0, 256, (50, 70, 3)).astype(np.uint8)
    Image.fromarray(image).save(d / "image.png")
    caption = "a red car next to a dog"
    got = _run("predict", str(d / "image.png"), caption, "--config", config99,
               "--checkpoint-dir", str(d / "ckpt"), "--thresh", "0",
               "--output", str(d / "overlay.png"))
    gcfg = load_config(config).grounding
    want = GroundingPredictor(learner.model, learner.keys,
                              BertTokenizer(max_len=16, vocab_size=512),
                              image_size=gcfg.image_size, score_thresh=0.0,
                              atss_cfg=gcfg.atss, device="cpu").predict(image, caption)
    assert got["task_id"] == want["task_id"] and got["entities"] == want["entities"]
    assert len(got["scores"]) > 0
    np.testing.assert_array_equal(got["scores"], want["scores"])
    np.testing.assert_array_equal(got["boxes"], want["boxes"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["task_id"] == got["task_id"] and printed["output"] == str(d / "overlay.png")
    assert Image.open(d / "overlay.png").size == (70, 50)


@pytest.mark.parametrize("kept", ["frozen", "pools"])
def test_the_eval_all_check_sees_a_faulty_restore(grounding, config99, kept):
    """The comparison that `eval-all --grounding` is held to can fail: a
    learner seeded 99 that restores session 1 but keeps its seeded frozen
    base, or its seeded pools, gives other head outputs than the training
    run's last evaluation (tasks 0 and 1)."""
    d, _, _, _, trained = grounding
    gcfg = load_config(config99).grounding
    learner = gl.GroundingLearner(gcfg, device="cpu")
    part = getattr(learner, kept)
    seeded = {n: p.detach().clone() for n, p in part.items()}
    learner.restore(SessionCheckpointer(str(d / "ckpt")), 1)
    load_in_place(part, seeded)
    tok = BertTokenizer(max_len=16, vocab_size=512)
    sets = {t: synthetic_grounding_task(t, max(gcfg.batch_size * 2, 8), gcfg.image_size, tok,
                                        gcfg.max_boxes) for t in (0, 1)}
    with _head_outputs() as got, deterministic():
        learner.evaluate(sets)
    assert len(got) < len(trained)
    assert not _same_heads(got, trained[len(trained) - len(got):])


# ---- what is not ported, and the platform -------------------------------------
@pytest.mark.parametrize("argv,item", [
    (["serve"], "§A.3"),
    (["eval-detection", "p.json", "--gt", "g.json"], "§A.6"),
    (["fetch-weights", "--list"], "§A.5"),
    (["train-grounding", "--dataset", "refexp_train"], "§A.3"),
])
def test_unported_commands_exit_naming_their_roadmap_item(argv, item):
    with pytest.raises(SystemExit) as e:
        cli.main(["--platform", "cpu", *argv])
    assert f"ROADMAP {item}" in str(e.value.code)


def test_the_module_runs_and_the_card_is_the_default():
    r = subprocess.run([sys.executable, "-m", "lpi_tpu_torch.cli.main", "fetch-weights"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "ROADMAP §A.5" in r.stderr
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default platform would run")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["eval", "--synthetic", "--checkpoint-dir", "unused"])
