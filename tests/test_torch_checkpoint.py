"""Session checkpoints and `restore`: the port against the JAX package, and
the port's own round trips.

Against the JAX package: a tiny JAX learner of each kind, untrained (no
step is compiled), gets pools and task keys drawn from a numpy seed; the
JAX `SessionCheckpointer` saves it and the JAX `restore` loads it into a
fresh JAX learner; its trees are carried into the port through `bridge`,
written with the port's checkpointer and restored into a fresh port learner
on the CPU. Both learners' `evaluate` must then agree: R@k, P@k and the
task-ID accuracies equal, the similarity matrices and the head outputs
within the repo's bar (relative Frobenius 1e-4, `_assert_close`).

The port's round trips: save then restore gives every tensor bit for bit;
`latest` and `session_<k>_results.json` are right; `restore` writes into
the model's own tensors (every pool and frozen leaf keeps its object and
`data_ptr`), so a step made before it trains the restored values; a
checkpoint whose names or shapes differ is refused, naming the first
mismatch, and leaves the model as it was.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lpi_tpu.continual import grounding_learner as jgl
from lpi_tpu.continual import learner as jlearner
from lpi_tpu.continual.keys import TaskKeys as JTaskKeys
from lpi_tpu.core import config as jc
from lpi_tpu.core.checkpoint import SessionCheckpointer as JCheckpointer
from lpi_tpu.data import retrieval as jdata
from lpi_tpu.data.bert_tokenizer import BertTokenizer as JBertTokenizer
from lpi_tpu.data.grounding import synthetic_grounding_task as j_synthetic
from lpi_tpu.data.tokenizer import ClipTokenizer as JClipTokenizer
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.bridge import keys_from_jax, params_from_jax, slinet_params_from_jax
from lpi_tpu_torch.continual import grounding_learner as tgl
from lpi_tpu_torch.continual import learner as tlearner
from lpi_tpu_torch.continual.keys import infer_task_ids
from lpi_tpu_torch.core.checkpoint import SessionCheckpointer
from lpi_tpu_torch.data import retrieval as tdata
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
from lpi_tpu_torch.data.grounding import synthetic_grounding_task
from lpi_tpu_torch.data.tokenizer import ClipTokenizer
from tests.test_composed_parity import _assert_close
from tests.test_torch_retrieval import _cfg as _retrieval_cfg

torch.set_num_threads(1)
DEPTHS = (2, 2, 2, 2)


def _grounding_cfg(c):
    """16 channels, one tower, the GroupNorm FPN, 64 px, 3 tasks, fp32, on
    the default deform route; the pre-NMS threshold is 0 so that the
    random-weight scores reach NMS."""
    return c.GroundingConfig(
        swin=c.SwinConfig(patch_size=4, embed_dim=8, depths=DEPTHS, num_heads=(1, 2, 2, 2),
                          window_size=4),
        bert=c.BertConfig(vocab_size=512, hidden_size=16, num_layers=8, num_heads=2,
                          intermediate_size=32, max_position_embeddings=32, max_query_len=16),
        dyhead=c.DyHeadConfig(num_convs=1, channels=16, max_tokens=16),
        atss=c.ATSSConfig(anchor_sizes=(32, 64, 128, 256, 512),
                          anchor_strides=(4, 8, 16, 32, 64), pre_nms_top_n=50,
                          fpn_post_nms_top_n=10, inference_thresh=0.0),
        lpi=c.LPIPromptConfig(prompt_length=4, prompt_depth=6, prompt_rank=2,
                              interact_rank=2, interact_depth=6),
        fpn_use_gn=True, total_tasks=3, epochs_per_task=1, batch_size=2, max_boxes=4,
        image_size=64, num_key_clusters=2, dtype="float32", fused_scan_unroll=99)


def _jax_pools(params, pool_keys, rng):
    """`params` with every pool leaf drawn from N(0, 0.5)."""
    flat = traverse_util.flatten_dict(params)
    for k, v in flat.items():
        if any(p in "/".join(k) for p in pool_keys):
            flat[k] = jnp.asarray((0.5 * rng.randn(*v.shape)).astype(np.float32))
    return traverse_util.unflatten_dict(flat)


def _jax_keys(rng, T, k, dim, valid):
    return JTaskKeys(jnp.asarray((rng.randn(T, k, dim) / 4).astype(np.float32)),
                     jnp.asarray(np.asarray(valid)))


def _port_keys(keys):
    return keys_from_jax(np.asarray(keys.centers), np.asarray(keys.valid))


def _write_port(directory, learner, session, **keys):
    """`learner` saved with the port's checkpointer: base, then the
    session."""
    ckpt = SessionCheckpointer(directory)
    ckpt.save_base(learner.frozen)
    ckpt.save_session(session, learner.pools, **keys)
    return ckpt


# ---- retrieval --------------------------------------------------------------
@pytest.fixture(scope="module")
def retrieval(tmp_path_factory):
    rng = np.random.RandomState(3)
    jl = jlearner.RetrievalLearner(_retrieval_cfg(jc))
    jl.params = _jax_pools(jl.params, jlearner.POOL_KEYS, rng)
    T, k, dim = 3, 2, 32
    jl.visual_keys = _jax_keys(rng, T, k, dim, [True, True, False])
    jl.textual_keys = _jax_keys(rng, T, k, dim, [True, True, False])
    jdir = tmp_path_factory.mktemp("jax_retrieval")
    jck = JCheckpointer(str(jdir))
    pools, frozen = jlearner._split_params(jl.params)
    jck.save_base(frozen)
    jck.save_session(1, pools, jl.visual_keys, jl.textual_keys, {"session": 1})
    jr = jlearner.RetrievalLearner(_retrieval_cfg(jc), rng_seed=7)
    assert jr.restore(JCheckpointer(str(jdir))) == 1

    carried = tlearner.RetrievalLearner(
        _retrieval_cfg(tc), device="cpu",
        init_params=slinet_params_from_jax(jax.tree.map(np.asarray, jr.params)))
    ck = _write_port(tmp_path_factory.mktemp("port_retrieval"), carried, 1,
                     visual_keys=_port_keys(jr.visual_keys),
                     textual_keys=_port_keys(jr.textual_keys))
    tl = tlearner.RetrievalLearner(_retrieval_cfg(tc), device="cpu",
                                   generator=torch.Generator().manual_seed(7))
    assert tl.restore(ck) == 1
    return jr, tl, dict(carried.model.named_parameters())


def test_retrieval_restore_from_a_jax_checkpoint_evaluates_as_jax(retrieval):
    """The carried checkpoint restores the JAX learner's weights exactly;
    per-sample task ids equal, similarity matrices at the bar, R@k and
    task-ID accuracies equal."""
    jr, tl, state = retrieval
    for name, p in tl.model.named_parameters():
        assert torch.equal(p.detach(), state[name]), name
    jev = jdata.synthetic_correlated_eval(2, 8, 32, JClipTokenizer(), 4)
    tev = tdata.synthetic_correlated_eval(2, 8, 32, ClipTokenizer(), 4)
    feats = {}
    for side, x, extract, keys, enc in (
            ("image", tev.images, tl.extract_visual, tl.visual_keys,
             tl.model.encode_image_tasks),
            ("text", tev.text_token_ids, tl.extract_textual, tl.textual_keys,
             tl.model.encode_text_tasks)):
        x = torch.as_tensor(x)
        ids = infer_task_ids(extract(x), keys)
        with torch.no_grad():
            feats[side] = (enc(x.float() if side == "image" else x.long(), ids), ids)
    jimg = jr.model.apply({"params": jr.params}, jnp.asarray(jev.images),
                          jnp.asarray(np.asarray(feats["image"][1])),
                          method=jr.model.encode_image_tasks)
    jtxt = jr.model.apply({"params": jr.params}, jnp.asarray(jev.text_token_ids),
                          jnp.asarray(np.asarray(feats["text"][1])),
                          method=jr.model.encode_text_tasks)
    _assert_close((feats["image"][0] @ feats["text"][0].T).numpy(),
                  np.asarray(jimg) @ np.asarray(jtxt).T)
    want = jr.evaluate(jev, num_tasks=2)
    got = tl.evaluate(tev, num_tasks=2)
    assert got["task_id_accuracy"] == want["task_id_accuracy"]
    assert got["i2t"] == want["i2t"] and got["t2i"] == want["t2i"]
    assert got["summary"] == pytest.approx(want["summary"], abs=0)


# ---- grounding ---------------------------------------------------------------
@pytest.fixture(scope="module")
def grounding(tmp_path_factory):
    """The JAX learner is saved, set back to its seeded weights, and
    restored: one JAX model init instead of two."""
    jtok = JBertTokenizer(max_len=16, vocab_size=512)
    jds = {t: j_synthetic(t, num_samples=3, image_size=64, tokenizer=jtok) for t in (0, 1)}
    rng = np.random.RandomState(5)
    jl = jgl.GroundingLearner(_grounding_cfg(jc), sample_batch=next(jds[0].batches(2)))
    seeded = jl.params
    jl.params = _jax_pools(jl.params, jgl.POOL_KEYS, rng)
    jl.keys = _jax_keys(rng, 3, 2, 16, [True, True, False])
    saved = jax.tree.map(np.asarray, jl.params), np.asarray(jl.keys.centers)
    jdir = tmp_path_factory.mktemp("jax_grounding")
    pools, frozen = jgl._split_params(jl.params)
    jck = JCheckpointer(str(jdir))
    jck.save_base(frozen)
    jck.save_session(0, pools, visual_keys=jl.keys)
    jl.params, jl.keys = seeded, None
    assert jl.restore(JCheckpointer(str(jdir))) == 0
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jl.params)),
                    jax.tree.leaves(saved[0])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(jl.keys.centers), saved[1])

    carried = tgl.GroundingLearner(
        _grounding_cfg(tc), device="cpu",
        init_params=params_from_jax(jax.tree.map(np.asarray, jl.params), depths=DEPTHS))
    ck = _write_port(tmp_path_factory.mktemp("port_grounding"), carried, 0,
                     visual_keys=_port_keys(jl.keys))
    tl = tgl.GroundingLearner(_grounding_cfg(tc), device="cpu",
                              generator=torch.Generator().manual_seed(7))
    assert tl.restore(ck) == 0
    return jl, tl, dict(carried.model.named_parameters()), jds


def test_grounding_restore_from_a_jax_checkpoint_evaluates_as_jax(grounding):
    """The carried checkpoint restores the JAX learner's weights exactly;
    the head outputs at the inferred task ids within the bar; P@1/5/10 and
    the task-ID accuracy equal."""
    jr, tl, state, jds = grounding
    for name, p in tl.model.named_parameters():
        assert torch.equal(p.detach(), state[name]), name
    tok = BertTokenizer(max_len=16, vocab_size=512)
    tds = {t: synthetic_grounding_task(t, num_samples=3, image_size=64, tokenizer=tok)
           for t in (0, 1)}
    want = jr.evaluate(jds)
    got = tl.evaluate(tds)
    assert got["task_id_accuracy"] == want["task_id_accuracy"]
    for t in want["per_task"]:
        np.testing.assert_array_equal(got["per_task"][t], want["per_task"][t])
    np.testing.assert_array_equal(got["overall"], want["overall"])
    batch, _, _ = next(tds[1].eval_batches(2))
    b = tl.to_device(batch)
    sel = infer_task_ids(tl.extract_features(batch["images"]), tl.keys)
    with torch.no_grad():
        ours, _ = tl.model.forward_tasks(b["images"], b["input_ids"], b["attention_mask"], sel)
    theirs, _ = jr._jit_cache["forward_tasks"](  # compiled by the evaluate above
        jr.params, jnp.asarray(batch["images"]), jnp.asarray(batch["input_ids"]),
        jnp.asarray(batch["attention_mask"]), jnp.asarray(sel.numpy()))
    for key in ("dot_logits", "bbox_pred", "centerness"):
        _assert_close(ours[key].numpy(), np.asarray(theirs[key]))


# ---- the port's own round trips -----------------------------------------------
def _filled(learner, seed):
    """`learner` with its pools and keys drawn from `seed`."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for p in learner.pools.values():
            p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    learner.keys = keys_from_jax(rng.randn(3, 2, 16), rng.rand(3) > 0.5)
    return learner


def test_save_then_restore_is_bit_exact_and_in_place(tmp_path):
    """Every parameter and the keys come back bit for bit into a learner
    of other weights; each leaf keeps its object and storage; `latest` and
    the results file are written."""
    src = _filled(tgl.GroundingLearner(_grounding_cfg(tc), device="cpu"), 10)
    ck = SessionCheckpointer(tmp_path)
    ck.save_base(src.frozen)
    ck.save_session(0, src.pools, visual_keys=src.keys, results={"overall": [1.0, 2.0, 3.0]})
    _filled(src, 11)
    ck.save_session(2, src.pools, visual_keys=src.keys)
    assert ck.latest_session() == 2 and ck.has_base()
    with open(tmp_path / "session_0_results.json") as f:
        assert json.load(f) == {"overall": [1.0, 2.0, 3.0]}
    assert not os.path.exists(tmp_path / "session_2_results.json")
    saved = ck.load_session(2)["pool_params"]
    assert all(v.device.type == "cpu" and v.data_ptr() != src.pools[n].data_ptr()
               for n, v in saved.items())

    dst = tgl.GroundingLearner(_grounding_cfg(tc), device="cpu",
                               generator=torch.Generator().manual_seed(99))
    leaves = {n: (p, p.data_ptr()) for n, p in dst.model.named_parameters()}
    assert dst.restore(ck) == 2
    for name, p in dst.model.named_parameters():
        assert p is leaves[name][0] and p.data_ptr() == leaves[name][1], name
        assert torch.equal(p, dict(src.model.named_parameters())[name]), name
    assert dst.pools["prompts.d1_share"] is leaves["prompts.d1_share"][0]
    assert torch.equal(dst.keys.centers, src.keys.centers)
    assert torch.equal(dst.keys.valid, src.keys.valid)
    assert dst.restore(ck, 0) == 0
    first = ck.load_session(0)["pool_params"]
    assert all(torch.equal(dst.pools[n], first[n]) for n in first)


def test_retrieval_restore_keeps_leaves_and_the_step_trains_them(retrieval, tmp_path):
    """A step made before `restore` trains the restored pools: after one
    step it equals a step from a learner that restored first."""
    _, src, _ = retrieval
    ck = SessionCheckpointer(tmp_path)
    ck.save_base(src.frozen)
    ck.save_session(0, src.pools, src.visual_keys, src.textual_keys)
    batch = next(tdata.synthetic_session(1, 8, 32, ClipTokenizer(), 4).batches(8))
    after = {}
    for order in ("step first", "restore first"):
        tl = tlearner.RetrievalLearner(_retrieval_cfg(tc), device="cpu",
                                       generator=torch.Generator().manual_seed(13))
        ptrs = {n: p.data_ptr() for n, p in tl.model.named_parameters()}
        if order == "step first":
            step = tl.make_train_step(1, steps_per_epoch=1, epochs=1)
            step(batch)
            tl.restore(ck)
            step = tl.make_train_step(1, steps_per_epoch=1, epochs=1)
        else:
            tl.restore(ck)
            step = tl.make_train_step(1, steps_per_epoch=1, epochs=1)
        step(batch)
        assert {n: p.data_ptr() for n, p in tl.model.named_parameters()} == ptrs
        assert torch.equal(tl.visual_keys.centers, src.visual_keys.centers)
        assert torch.equal(tl.textual_keys.valid, src.textual_keys.valid)
        after[order] = {n: p.detach().clone() for n, p in tl.pools.items()}
    for name, p in after["restore first"].items():
        assert torch.equal(after["step first"][name], p), name
        assert not torch.equal(p[1], src.pools[name][1]), name


def test_mismatched_checkpoint_is_refused_and_changes_nothing(retrieval, tmp_path):
    _, src, _ = retrieval
    bigger = dataclasses.replace(_retrieval_cfg(tc),
                                 lpi=dataclasses.replace(_retrieval_cfg(tc).lpi,
                                                         prompt_length=5))
    other = tlearner.RetrievalLearner(bigger, device="cpu")
    ck = SessionCheckpointer(tmp_path / "shape")
    ck.save_base(other.frozen)
    ck.save_session(0, other.pools, other.visual_keys, other.textual_keys)
    before = {n: p.detach().clone() for n, p in src.model.named_parameters()}
    keys = src.visual_keys
    with pytest.raises(ValueError, match=r"'prompts\.d2_visual'"):
        src.restore(ck)
    ck = SessionCheckpointer(tmp_path / "names")
    ck.save_base({n: p for n, p in src.frozen.items() if n != "clip.logit_scale"})
    ck.save_session(0, src.pools)
    with pytest.raises(ValueError, match="no entry 'clip.logit_scale'"):
        src.restore(ck)
    ck = SessionCheckpointer(tmp_path / "extra")
    ck.save_base({**src.frozen, "clip.extra": torch.zeros(1)})
    ck.save_session(0, src.pools)
    with pytest.raises(ValueError, match="'clip.extra' is not in the model"):
        src.restore(ck)
    for n, p in src.model.named_parameters():
        assert torch.equal(p, before[n]), n
    assert src.visual_keys is keys
    with pytest.raises(ValueError, match="no sessions"):
        src.restore(SessionCheckpointer(tmp_path / "empty"))
