"""The port's `serve` (`lpi_tpu_torch/serve/predictor.py:launch_webui`,
`cli/main.py:cmd_serve`) against the JAX package's, on the CPU, through a
stub `gradio` module put into `sys.modules` (its `Interface` records what
it is given, `launch` returns at once).

Both packages' `launch_webui` build the same interface and their `infer`
draws the same pixels for the same predictions; on a tiny predictor of the
port `infer` equals `draw_predictions` / `draw_predictions_metric` of its
`predict`; `serve --platform cpu` builds that predictor from a `--config`
and launches it on `--port`; without `gradio` both raise the same error.
"""

import json
import sys
import types

import numpy as np
import pytest
import torch

from lpi_tpu.serve import predictor as jp
from lpi_tpu_torch.cli import main as cli
from lpi_tpu_torch.config import load_config
from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
from lpi_tpu_torch.serve import predictor as tp
from tests.test_torch_cli import CONFIG

torch.set_num_threads(1)
CAPTION = "a red car next to a dog"


class _Widget:
    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs

    def __eq__(self, other):
        return (type(self).__name__, self.args, self.kwargs) == (
            type(other).__name__, other.args, other.kwargs)


def _stub_gradio():
    """A `gradio` module whose `Interface` keeps its arguments and whose
    `launch` records its keywords and returns."""
    gr = types.ModuleType("gradio")
    gr.launched = []

    class Interface:
        def __init__(self, fn, inputs, outputs, title):
            self.fn, self.inputs, self.outputs, self.title = fn, inputs, outputs, title

        def launch(self, **kwargs):
            gr.launched.append((self, kwargs))

    gr.Interface = Interface
    gr.Textbox = type("Textbox", (_Widget,), {})
    gr.Image = type("Image", (_Widget,), {})
    gr.Dropdown = type("Dropdown", (_Widget,), {})
    return gr


class _Fixed:
    """A predictor that returns fixed detections."""

    def __init__(self, result):
        self.result, self.calls = result, []

    def predict(self, image, caption):
        self.calls.append((np.asarray(image).shape, caption))
        return self.result


def _pixels(im):
    return np.asarray(im.convert("RGB"))


@pytest.fixture
def image():
    return np.random.RandomState(2).randint(0, 256, (60, 80, 3)).astype(np.uint8)


def test_launch_webui_builds_the_jax_interface_and_draws_its_pixels(monkeypatch, image):
    result = {"boxes": [[5.0, 6.0, 40.0, 30.0], [20.0, 10.0, 70.0, 55.0], [1.0, 2.0, 9.0, 9.0]],
              "scores": [0.8, 0.65, 0.3], "entities": ["a red car", "a dog", "a red car"]}
    demos = {}
    for name, mod in (("jax", jp), ("port", tp)):
        gr = _stub_gradio()
        monkeypatch.setitem(sys.modules, "gradio", gr)
        predictor = _Fixed(result)
        assert mod.launch_webui(predictor, port=7861) is None
        (demo, kwargs), = gr.launched
        assert kwargs == {"server_port": 7861}
        demos[name] = (demo, predictor)
    (jdemo, jpred), (tdemo, tpred) = demos["jax"], demos["port"]
    assert (tdemo.inputs, tdemo.outputs, tdemo.title) == (jdemo.inputs, jdemo.outputs, jdemo.title)
    for metric in ("all", "R@1", "R@5", "R@10"):
        np.testing.assert_array_equal(_pixels(tdemo.fn(CAPTION, image, metric)),
                                      _pixels(jdemo.fn(CAPTION, image, metric)))
    assert tpred.calls == jpred.calls == [((60, 80, 3), CAPTION)] * 4


@pytest.fixture(scope="module")
def tiny_predictor():
    gcfg = load_config(overrides={"grounding": CONFIG["grounding"]}).grounding
    learner = GroundingLearner(gcfg, device="cpu")
    return tp.GroundingPredictor(learner.model, learner.keys,
                                 BertTokenizer(max_len=16, vocab_size=512),
                                 image_size=gcfg.image_size, score_thresh=0.0,
                                 atss_cfg=gcfg.atss, device="cpu")


def test_infer_equals_the_drawings_of_predict(monkeypatch, tiny_predictor, image):
    gr = _stub_gradio()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    tp.launch_webui(tiny_predictor)
    (demo, kwargs), = gr.launched
    assert kwargs == {"server_port": 7860}
    result = tiny_predictor.predict(image, CAPTION)
    assert len(result["scores"]) > 0
    np.testing.assert_array_equal(_pixels(demo.fn(CAPTION, image, "all")),
                                  _pixels(tp.draw_predictions(image, result)))
    for metric in ("R@1", "R@5"):
        want, _ = tp.draw_predictions_metric(image, result, metric=metric)
        np.testing.assert_array_equal(_pixels(demo.fn(CAPTION, image, metric)), _pixels(want))


def test_without_gradio_both_raise_the_same_error(monkeypatch, tiny_predictor):
    monkeypatch.setitem(sys.modules, "gradio", None)  # `import gradio` raises ImportError
    errors = []
    for mod, predictor in ((jp, None), (tp, tiny_predictor)):
        with pytest.raises(RuntimeError) as e:
            mod.launch_webui(predictor)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "gradio is not installed in this environment"


def test_cmd_serve_on_the_cpu_launches_the_configs_predictor(monkeypatch, tmp_path, image):
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(CONFIG))
    gr = _stub_gradio()
    monkeypatch.setitem(sys.modules, "gradio", gr)
    predictor = cli.main(["--platform", "cpu", "serve", "--config", str(path), "--port", "7870"])
    (demo, kwargs), = gr.launched
    assert kwargs == {"server_port": 7870}
    assert isinstance(predictor, tp.GroundingPredictor) and predictor.device.type == "cpu"
    assert predictor.image_size == CONFIG["grounding"]["image_size"]
    result = predictor.predict(image, CAPTION)
    np.testing.assert_array_equal(_pixels(demo.fn(CAPTION, image, "all")),
                                  _pixels(tp.draw_predictions(image, result)))
