"""The continual-grounding train step: the port against the JAX package.

One tiny JAX learner (tests/test_grounding.py's TINY with one 128-channel
tower, so that every deformable conv takes the Pallas route, in interpret
mode) is built once per module, and its weights are carried into the port's
learner by `lpi_tpu_torch.bridge.params_from_jax`. The JAX side's train
forward and `value_and_grad(_losses)` at task 1 are compiled once, in one
jitted function. The optimizer is held to optax on small arrays; the JAX
learner's whole step is not jitted here (minutes on the CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from lpi_tpu.continual import grounding_learner as jgl
from lpi_tpu.continual.keys import TaskKeys as JTaskKeys
from lpi_tpu.data.bert_tokenizer import BertTokenizer as JTokenizer
from lpi_tpu.data.grounding import GroundingTaskSet as JTaskSet
from lpi_tpu.data.grounding import synthetic_grounding_task as j_synthetic
from lpi_tpu.ops.kmeans import _lloyd as j_lloyd
from lpi_tpu.core import config as jc
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.bridge import params_from_jax
from lpi_tpu_torch.continual import grounding_learner as tgl
from lpi_tpu_torch.continual.keys import TaskKeys
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
from lpi_tpu_torch.data.grounding import GroundingTaskSet, synthetic_grounding_task
from lpi_tpu_torch.ops import deform_window_kernel as tdk
from lpi_tpu_torch.ops.kmeans import kmeans, lloyd
from tests.test_composed_parity import _assert_close

torch.set_num_threads(1)
TASK = 1  # a task other than 0: the task loss is live and the one-hot picks row 1


def _tiny(c, **kw):
    """tests/test_grounding.py's TINY, with the head at 128 channels and one
    tower (the JAX package's Pallas route)."""
    return c.GroundingConfig(
        swin=c.SwinConfig(patch_size=4, embed_dim=8, depths=(2, 2, 2, 2),
                          num_heads=(1, 2, 2, 2), window_size=4),
        bert=c.BertConfig(vocab_size=512, hidden_size=16, num_layers=8, num_heads=2,
                          intermediate_size=32, max_position_embeddings=32,
                          max_query_len=16),
        fused_scan_unroll=99,
        dyhead=c.DyHeadConfig(num_convs=1, channels=128, max_tokens=16),
        atss=c.ATSSConfig(anchor_sizes=(8, 16, 32, 64, 128),
                          anchor_strides=(4, 8, 16, 32, 64), pre_nms_top_n=50,
                          fpn_post_nms_top_n=10),
        lpi=c.LPIPromptConfig(prompt_length=4, prompt_depth=6, prompt_rank=2,
                              interact_rank=2, interact_depth=6),
        total_tasks=3, epochs_per_task=1, batch_size=2, max_boxes=4,
        image_size=64, num_key_clusters=2, dtype="float32", **kw)


def _torch_names(flat_jax: dict) -> dict:
    """JAX flat {path tuple: array} -> {torch parameter name: tensor}."""
    tree = traverse_util.unflatten_dict({k: np.asarray(v) for k, v in flat_jax.items()})
    return params_from_jax(tree, depths=(2, 2, 2, 2))


@pytest.fixture(scope="module")
def pair():
    """The JAX learner and the port's learner on the same weights, with the
    JAX train forward, losses and pool gradients at task 1 on one batch."""
    jtok = JTokenizer(max_len=16, vocab_size=512)
    jds = j_synthetic(TASK, num_samples=4, image_size=64, tokenizer=jtok)
    batch = next(jds.batches(2))
    jl = jgl.GroundingLearner(_tiny(jc), task_sim_matrix=np.eye(3), sample_batch=batch)
    pools, frozen = jgl._split_params(jl.params)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def forward_and_grads(pools, frozen, b):
        params = jgl._merge(pools, frozen)
        out = jl.model.apply({"params": params}, b["images"], b["input_ids"],
                             b["attention_mask"], TASK)
        return out, jax.value_and_grad(jl._losses, has_aux=True)(pools, frozen, b, TASK)

    (flat, language, vis_p, txt_p), ((total, metrics), grads) = forward_and_grads(
        pools, frozen, jbatch)
    tl = tgl.GroundingLearner(_tiny(tc), task_sim_matrix=np.eye(3),
                              init_params=params_from_jax(jax.tree.map(np.asarray, jl.params),
                                                          depths=(2, 2, 2, 2)),
                              device="cpu")
    return dict(jl=jl, tl=tl, batch=batch, flat=flat, language=language, vis_p=vis_p,
                txt_p=txt_p, total=total, metrics=metrics, grads=_torch_names(grads),
                pool_names=set(_torch_names(pools)))


def test_pool_split_matches_jax(pair):
    tl = pair["tl"]
    assert set(tl.pools) == pair["pool_names"]
    assert all(p.requires_grad for p in tl.pools.values())
    assert not any(p.requires_grad for p in tl.frozen.values())


def test_train_forward_matches_jax(pair):
    tl = pair["tl"]
    b = tl.to_device(pair["batch"])
    with torch.no_grad():
        flat, language, vis_p, txt_p = tl.model(b["images"], b["input_ids"],
                                                b["attention_mask"], TASK)
    for key in ("bbox_pred", "centerness", "dot_logits", "anchors"):
        _assert_close(flat[key].numpy(), pair["flat"][key])
    for key in ("embedded", "aggregate"):
        _assert_close(language[key].numpy(), pair["language"][key])
    _assert_close(vis_p.numpy(), pair["vis_p"])
    _assert_close(txt_p.numpy(), pair["txt_p"])


def test_losses_and_pool_gradients_match_jax(pair):
    """Each loss term and the concatenated gradient of the pools (and each
    leaf) within relative Frobenius 1e-4 of `jax.value_and_grad(_losses)`."""
    tl = pair["tl"]
    total, metrics = tl._losses(tl.to_device(pair["batch"]), TASK)
    names = sorted(tl.pools)
    grads = torch.autograd.grad(total, [tl.pools[n] for n in names])
    want = pair["metrics"]
    assert metrics["num_pos"].item() == float(want["num_pos"]) > 0
    assert float(want["task_loss"]) > 0
    for key in ("loss_reg", "loss_centerness", "loss_dot_product_token",
                "alignment_loss", "task_loss"):
        _assert_close(np.float64(metrics[key].item()), np.float64(want[key]))
    _assert_close(np.float64(total.item()), np.float64(pair["total"]))
    ours = np.concatenate([g.numpy().ravel() for g in grads])
    theirs = np.concatenate([pair["grads"][n].numpy().ravel() for n in names])
    _assert_close(ours, theirs)
    for n, g in zip(names, grads):
        _assert_close(g.numpy(), pair["grads"][n].numpy())
        # the unseen task 2 gets none (task 0's rows do, through the task
        # loss: the one-hot of the step removes those)
        assert g[2].abs().sum() == 0 and g[TASK].abs().sum() > 0, n


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_masked_clip_adamw_step_matches_optax(scale):
    """Two masked steps at task 1 on the same gradients, with the gradient
    norm below the clip (scale 0.01) and above it (scale 10)."""
    rng = np.random.RandomState(0)
    cfg = tc.GroundingConfig()
    shapes = {"a": (3, 4, 5), "b": (3, 7)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    steps = [{k: (rng.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    lrs = [0.01, 0.005]

    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                     optax.inject_hyperparams(optax.adamw)(learning_rate=0.0,
                                                          weight_decay=cfg.weight_decay))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    onehot = {k: jax.nn.one_hot(TASK, 3).reshape((3,) + (1,) * (len(s) - 1))
              for k, s in shapes.items()}
    tp = [torch.from_numpy(params[k].copy()) for k in shapes]
    masks = [torch.from_numpy(np.array(onehot[k])) for k in shapes]
    tstate = tgl.AdamState.zeros(tp)
    for g, lr in zip(steps, lrs):
        clip_state, inj = state
        inj = inj._replace(hyperparams=dict(inj.hyperparams, learning_rate=jnp.float32(lr)))
        jg = {k: jnp.asarray(v) * onehot[k] for k, v in g.items()}
        upd, state = tx.update(jg, (clip_state, inj), jp)
        jp = optax.apply_updates(jp, {k: u * onehot[k] for k, u in upd.items()})
        tg = [torch.from_numpy(g[k]) * mk for k, mk in zip(shapes, masks)]
        tgl.adamw_update(tp, tgl.clip_by_global_norm(tg, cfg.grad_clip), tstate, lr,
                         cfg.weight_decay, masks)
        for k, t in zip(shapes, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    for k, t in zip(shapes, tp):  # the other tasks' rows never move
        np.testing.assert_array_equal(t.numpy()[[0, 2]], params[k][[0, 2]])


def _fresh_learner():
    return tgl.GroundingLearner(_tiny(tc), task_sim_matrix=np.eye(3),
                                generator=torch.Generator().manual_seed(1), device="cpu")


def _tasks(task, n=4, seed=0):
    tok = BertTokenizer(max_len=16, vocab_size=512)
    return synthetic_grounding_task(task, num_samples=n, image_size=64, tokenizer=tok,
                                    seed=seed)


def test_a_non_finite_loss_counts_zero(monkeypatch):
    """A NaN loss term is zeroed (engine/trainer.py's rule): the metric reads
    0, the total stays finite and the step still moves the task's row."""
    real = tgl.atss_losses

    def nan_reg(*a, **kw):
        out = real(*a, **kw)
        return {**out, "loss_reg": out["loss_reg"] + float("nan")}

    monkeypatch.setattr(tgl, "atss_losses", nan_reg)
    tl = _fresh_learner()
    before = {n: p.detach().clone() for n, p in tl.pools.items()}
    metrics = tl.make_step(TASK, 1, 1)(next(_tasks(TASK).batches(2)))
    assert metrics["loss_reg"].item() == 0.0 and torch.isfinite(metrics["total"])
    assert metrics["loss_dot_product_token"].item() > 0
    for n, p in tl.pools.items():
        assert torch.isfinite(p).all(), n
    assert any(not torch.equal(p[TASK], before[n][TASK]) for n, p in tl.pools.items())


def test_two_step_train_task_moves_only_its_row_and_sets_its_keys():
    tl = _fresh_learner()
    before = {n: p.detach().clone() for n, p in tl.model.named_parameters()}
    tdk.reset_launch_counts()
    out = tl.train_task(_tasks(TASK), epochs=1)  # 4 samples, batch 2: two steps
    for key in ("total", "loss_reg", "loss_centerness", "loss_dot_product_token",
                "alignment_loss", "task_loss", "num_pos", "samples_per_sec"):
        assert np.isfinite(out[key]), key
    assert out["task_loss"] > 0
    for n, p in tl.model.named_parameters():
        if n in tl.pools:
            assert torch.equal(p[0], before[n][0]) and torch.equal(p[2], before[n][2]), n
        else:
            assert torch.equal(p, before[n]), n
    assert sum(not torch.equal(p[TASK], before[n][TASK]) for n, p in tl.pools.items()) >= 10
    assert tl.keys.valid.tolist() == [False, True, False]
    assert tl.keys.centers[[0, 2]].abs().sum() == 0 and tl.keys.centers[TASK].abs().sum() > 0
    assert all(fn.launches == 0 for fn in tdk.KERNELS)  # the CPU runs plain versions


def test_pretrain_moves_every_parameter_and_refreezes():
    tl = _fresh_learner()
    before = {n: p.detach().clone() for n, p in tl.model.named_parameters()}
    out = tl.pretrain(_tasks(0), steps=1)
    assert np.isfinite(out["total"])
    moved = [n for n, p in tl.model.named_parameters() if not torch.equal(p, before[n])]
    assert any("swin" in n for n in moved) and any("prompts" in n for n in moved)
    assert not any(p.requires_grad for p in tl.frozen.values())


def test_lloyd_matches_jax_from_the_same_centres(rng):
    x = np.concatenate([rng.randn(15, 6) + 4, rng.randn(15, 6) - 4, rng.randn(10, 6)])
    x = x.astype(np.float32)
    init = x[[0, 1, 20]].copy()
    jc_, ji = j_lloyd(jnp.asarray(x), jnp.asarray(init), 7)
    tc_, ti = lloyd(torch.from_numpy(x), torch.from_numpy(init), 7)
    np.testing.assert_allclose(tc_.numpy(), np.asarray(jc_), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ti.item(), float(ji), rtol=1e-5)


def test_kmeans_is_seeded_and_finds_separated_clusters(rng):
    x = np.concatenate([rng.randn(12, 4) * 0.1 + c for c in (-5.0, 0.0, 5.0)]).astype(np.float32)
    a, ia = kmeans(torch.from_numpy(x), torch.Generator().manual_seed(3), k=3)
    b, ib = kmeans(torch.from_numpy(x), torch.Generator().manual_seed(3), k=3)
    assert torch.equal(a, b) and ia.item() == ib.item()
    np.testing.assert_allclose(np.sort(a.numpy()[:, 0]), [-5.0, 0.0, 5.0], atol=0.1)


def test_task_keys_create_and_update_match_jax(rng):
    centers = rng.randn(2, 5).astype(np.float32)
    jk = JTaskKeys.create(3, 2, 5).update(1, jnp.asarray(centers))
    tk = TaskKeys.create(3, 2, 5).update(1, torch.from_numpy(centers))
    np.testing.assert_array_equal(tk.centers.numpy(), np.asarray(jk.centers))
    np.testing.assert_array_equal(tk.valid.numpy(), np.asarray(jk.valid))


@pytest.mark.parametrize("task,drop", [(0, True), (2, False), (11, True)])
def test_synthetic_batches_equal_jax(task, drop):
    jtok, tok = JTokenizer(max_len=16, vocab_size=512), BertTokenizer(max_len=16, vocab_size=512)
    jds = j_synthetic(task, num_samples=5, image_size=32, tokenizer=jtok, seed=3)
    ds = synthetic_grounding_task(task, num_samples=5, image_size=32, tokenizer=tok, seed=3)
    jcat = JTaskSet.concat([jds, jds])
    cat = GroundingTaskSet.concat([ds, ds])
    assert len(cat) == len(jcat) == 10
    for ours, theirs in ((ds, jds), (cat, jcat)):
        got = list(ours.batches(2, seed=7, drop_remainder=drop))
        want = list(theirs.batches(2, seed=7, drop_remainder=drop))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])


def test_augment_is_not_ported_yet():
    """Only the reference's default augmentation is ported (restrict-resize,
    flip at 0.5, BGR*255 normalisation); its colour jitter and multi-scale
    knobs are not ported yet. A task set with `augment_size` gives the JAX
    package's train and eval batches (with `AugmentConfig(image_size)`)
    exactly."""
    from lpi_tpu.data.transforms import AugmentConfig as JAugment

    ds = dataclasses.replace(_tasks(0, n=3), augment_size=48)
    jds = JTaskSet(ds.examples, JTokenizer(max_len=16, vocab_size=512), max_boxes=ds.max_boxes,
                   task_index=0, augment=JAugment(image_size=48))
    for got, want in zip(ds.batches(2, seed=3, drop_remainder=False),
                         jds.batches(2, seed=3, drop_remainder=False), strict=True):
        assert got["images"].shape == (2, 48, 48, 3)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    for (got, n, idx), (want, jn, jidx) in zip(ds.eval_batches(2), jds.eval_batches(2),
                                               strict=True):
        assert (n, idx) == (jn, jidx)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
