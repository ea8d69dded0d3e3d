"""Continual-retrieval evaluation and the benchmark entry points: the port
against the JAX package.

`tests/test_torch_retrieval.py`'s tiny learners (the retrieval gate's
config, fp32, weights carried by `bridge.slinet_params_from_jax`). The task
keys: k-means from equal initial centres (the two packages' random draws
cannot match, so the port's seeding is replaced by the centres given to
JAX's Lloyd iterations). Ranks and R@k must be equal; features and centres
are held to the repo's bar.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.core import config as jc
from lpi_tpu.data import retrieval as jdata
from lpi_tpu.data.tokenizer import ClipTokenizer as JTok
from lpi_tpu.eval import retrieval as jeval
from lpi_tpu.ops.kmeans import _lloyd as j_lloyd
from lpi_tpu_torch import bench
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.bridge import keys_from_jax
from lpi_tpu_torch.data import retrieval as tdata
from lpi_tpu_torch.data.tokenizer import ClipTokenizer
from lpi_tpu_torch.eval import retrieval as teval
from lpi_tpu_torch.ops import kmeans as tkmeans
from tests.test_composed_parity import _assert_close
from tests.test_torch_retrieval import _cfg, _learners, _session

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return _learners()


def test_cluster_task_matches_jax_from_equal_centres(pair, monkeypatch):
    """`cluster_task`: the frozen fp32 features of the session's batches
    (visual and textual) and the k-means keys from equal initial centres
    (the session's first k samples), against JAX's `extract_*` and Lloyd
    iterations; the task marked valid."""
    jl, tl = pair
    ds = _session(1, 12)
    k = tl.cfg.num_key_clusters
    monkeypatch.setattr(tkmeans, "_plusplus_init", lambda gen, x, k: x[:k].clone())
    tl.cluster_task(tdata.RetrievalTrainSet(ds.images, ds.token_ids, 1))
    for field, extract, keys in (("images", jl.extract_visual, tl.visual_keys),
                                 ("token_ids", jl.extract_textual, tl.textual_keys)):
        x = np.concatenate([np.asarray(extract(b[field]))
                            for b in ds.batches(8, seed=0, drop_remainder=False)])[:len(ds)]
        want, _ = j_lloyd(jnp.asarray(x), jnp.asarray(x[:k]), 50)
        _assert_close(keys.centers[1].numpy(), np.asarray(want))
        assert keys.valid.tolist() == [False, True, False]
    with torch.no_grad():
        _assert_close(tl.extract_visual(ds.images).numpy(),
                      np.asarray(jl.extract_visual(ds.images)))


@pytest.mark.parametrize("captions", [1, 3])
def test_device_ranks_and_itm_eval_match_jax(captions):
    """Integer ranks both ways exactly equal to JAX's device ranks and to
    the host argsort path; R@k per task and the summary equal."""
    rng = np.random.RandomState(captions)
    n_img = 13
    img = rng.randn(n_img, 16).astype(np.float32)
    txt = rng.randn(n_img * captions, 16).astype(np.float32)
    txt2img = {t: t // captions for t in range(len(txt))}
    img2txt = {i: list(range(i * captions, (i + 1) * captions)) for i in range(n_img)}
    got = teval.device_ranks(torch.from_numpy(img), torch.from_numpy(txt), txt2img, img2txt)
    want = jeval.device_ranks(img, txt, txt2img, img2txt)
    scores = img.astype(np.float64) @ txt.T.astype(np.float64)
    host = (teval._ranks_i2t(scores, img2txt), teval._ranks_t2i(scores.T, txt2img))
    for g, w, h in zip(got, want, host):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, h)
    img_cat = np.arange(n_img) % 3
    txt_cat = img_cat[[txt2img[t] for t in range(len(txt))]]
    ours = teval.itm_eval(None, None, txt2img, img2txt, img_cat, txt_cat, 3, ranks=got)
    theirs = jeval.itm_eval(None, None, txt2img, img2txt, img_cat, txt_cat, 3, ranks=want)
    assert ours["i2t"] == theirs["i2t"] and ours["t2i"] == theirs["t2i"]
    assert ours["summary"] == pytest.approx(theirs["summary"], abs=0)
    sessions = {0: ours, 1: ours, 2: teval.itm_eval(scores, scores.T, txt2img, img2txt,
                                                     img_cat, txt_cat, 3)}
    jsessions = {0: theirs, 1: theirs, 2: jeval.itm_eval(scores, scores.T, txt2img, img2txt,
                                                         img_cat, txt_cat, 3)}
    assert teval.aggregate_results(sessions) == jeval.aggregate_results(jsessions)


def test_evaluate_matches_jax(pair):
    """`evaluate` on a 3-task `synthetic_correlated_eval` set with equal
    task keys (JAX's, carried): per-sample task ids, then prompted features
    and ranks; the task-ID accuracies, per-task R@k and the summary equal."""
    jl, tl = pair
    for t in range(3):
        jl.cluster_task(_session(t, 12))
    tl.visual_keys = keys_from_jax(np.asarray(jl.visual_keys.centers),
                                   np.asarray(jl.visual_keys.valid))
    tl.textual_keys = keys_from_jax(np.asarray(jl.textual_keys.centers),
                                    np.asarray(jl.textual_keys.valid))
    jev = jdata.synthetic_correlated_eval(3, 8, 32, JTok(), 4)
    tev = tdata.synthetic_correlated_eval(3, 8, 32, ClipTokenizer(), 4)
    want = jl.evaluate(jev, num_tasks=3)
    got = tl.evaluate(tev, num_tasks=3)
    assert got["task_id_accuracy"] == want["task_id_accuracy"]
    assert got["i2t"] == want["i2t"] and got["t2i"] == want["t2i"]
    assert got["summary"] == pytest.approx(want["summary"], abs=0)


# ---- the benchmark entry points, on the CPU at tiny shapes ----------------
def test_bench_retrieval_runs_on_the_cpu():
    """Wiring only: the bench's step on the tiny config for two steps."""
    sps = bench.bench_retrieval("cpu", cfg=_cfg(tc), iters=2)
    assert np.isfinite(sps) and sps > 0


def test_bench_quality_retrieval_keys_on_the_cpu():
    """Wiring and keys only (two pretrain steps, one epoch a session: far
    from the bars): the keys of `bench.py`'s quality line, in range."""
    out = bench.bench_quality_retrieval("cpu", pretrain_steps=2, epochs=1)
    assert list(out) == ["task_id_acc_visual", "task_id_acc_textual", "txt_r1", "img_r1",
                         "i2t_p1_average", "i2t_forgetting"]
    assert all(0 <= out[k] <= 1 for k in ("task_id_acc_visual", "task_id_acc_textual"))
    assert all(0 <= out[k] <= 100 for k in ("txt_r1", "img_r1", "i2t_p1_average"))
    assert isinstance(bench.retrieval_quality_ok(out), bool)
    assert bench.RETRIEVAL_BARS == {"r1": 50.0, "task_id": 0.8, "forgetting": 10.0}


def test_gate_config_matches_the_reference_bench():
    """`gate_retrieval_config` is `bench.py:180-189` field for field (the
    tests' tiny config copies those lines)."""
    assert dataclasses.asdict(bench.gate_retrieval_config()) == dataclasses.asdict(_cfg(jc))
