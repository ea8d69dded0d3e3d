"""The grounding baselines (S-Prompts without interaction, MaPLe in
replace mode): the port against the JAX package.

Each pool's tiny learner (`tests/test_grounding.py`'s TINY with one
16-channel tower, at 32 px) is built in JAX with the grounding section of
`configs/baselines/sprompts.json` or `configs/baselines/maple.json`, and its
weights carried into the port by `bridge.params_from_jax`. The JAX side's
`value_and_grad(_losses)` at task 1 is compiled once, with the train
forward's outputs taken from inside it (JAX compiles the tiny GLIP slowly
on the CPU: a second program would double the file's time). Outputs,
losses (the same keys) and pool gradients (MaPLe's projections included)
are held to the repo's bar (relative Frobenius 1e-4 and an absolute cap of
3e-3); `forward_tasks` with per-sample tasks to the train forward of each
sample's task; one masked clip + AdamW step to optax's on JAX's gradients,
the other tasks' rows bit-equal. Then a checkpoint round trip with
`restore`, the bridge and the converter on the new leaves, and
`train-grounding --synthetic` on the command line, on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from lpi_tpu.continual import grounding_learner as jgl
from lpi_tpu.core import config as jc
from lpi_tpu.data.bert_tokenizer import BertTokenizer as JTokenizer
from lpi_tpu.data.grounding import synthetic_grounding_task as j_synthetic
from lpi_tpu.models.glip import convert as jglip
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.bridge import params_from_jax
from lpi_tpu_torch.continual import grounding_learner as tgl
from lpi_tpu_torch.core.checkpoint import SessionCheckpointer
from lpi_tpu_torch.models.glip import convert as tglip
from lpi_tpu_torch.prompts.pools import MaPLePromptPool, NormalPromptPool
from tests.test_composed_parity import _assert_close

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK = 1
SIZE = 32
KINDS = ("sprompts", "maple")
POOLS = {"sprompts": {"prompts.visual_prompt", "prompts.textual_prompt"},
         "maple": {"prompts.textual", "prompts.proj_kernel", "prompts.proj_bias"}}
DET = {"loss_reg", "loss_centerness", "loss_dot_product_token", "num_pos"}
KEYS = {"sprompts": DET, "maple": DET | {"alignment_loss", "task_loss"}}


def lpi_section(kind) -> dict:
    with open(os.path.join(REPO, "configs", "baselines", f"{kind}.json")) as f:
        return json.load(f)["grounding"]["lpi"]


def _tiny(c, kind):
    """tests/test_grounding.py's TINY with one tower, and the baseline's
    grounding lpi section."""
    return c.GroundingConfig(
        swin=c.SwinConfig(patch_size=4, embed_dim=8, depths=(2, 2, 2, 2),
                          num_heads=(1, 2, 2, 2), window_size=4),
        bert=c.BertConfig(vocab_size=512, hidden_size=16, num_layers=8, num_heads=2,
                          intermediate_size=32, max_position_embeddings=32,
                          max_query_len=16),
        fused_scan_unroll=99,
        dyhead=c.DyHeadConfig(num_convs=1, channels=16, max_tokens=16),
        atss=c.ATSSConfig(anchor_sizes=(8, 16, 32, 64, 128),
                          anchor_strides=(4, 8, 16, 32, 64), pre_nms_top_n=50,
                          fpn_post_nms_top_n=10),
        lpi=c.LPIPromptConfig(prompt_length=4, prompt_depth=6, prompt_rank=2,
                              interact_rank=2, interact_depth=6, **lpi_section(kind)),
        total_tasks=3, epochs_per_task=1, batch_size=2, max_boxes=4,
        image_size=SIZE, num_key_clusters=2, dtype="float32")


def _torch_names(flat_jax: dict) -> dict:
    tree = traverse_util.unflatten_dict({k: np.asarray(v) for k, v in flat_jax.items()})
    return params_from_jax(tree, depths=(2, 2, 2, 2))


def _batch(task=TASK, n=4, seed=0):
    ds = j_synthetic(task, num_samples=n, image_size=SIZE,
                     tokenizer=JTokenizer(max_len=16, vocab_size=512), seed=seed)
    return next(ds.batches(2))


class _Spy:
    """Stands in for the JAX learner's model: records what each train
    forward (`apply` without a method) returns."""

    def __init__(self, model):
        self.model, self.seen = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def apply(self, *args, **kw):
        out = self.model.apply(*args, **kw)
        if kw.get("method") is None:
            flat, language, vis_p, txt_p = out
            self.seen.append(({k: flat[k] for k in ("bbox_pred", "centerness", "dot_logits",
                                                    "anchors")},
                              {k: language[k] for k in ("embedded", "aggregate")},
                              vis_p, txt_p))
        return out


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    """The JAX learner and the port's on the same weights, with JAX's losses
    and pool gradients at task 1 on one batch and the train forward's
    outputs that they came from."""
    kind = request.param
    batch = _batch()
    jl = jgl.GroundingLearner(_tiny(jc, kind), task_sim_matrix=np.eye(3), sample_batch=batch)
    pools, frozen = jgl._split_params(jl.params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    spy = _Spy(jl.model)

    def losses(p, fz, b):
        total, metrics = jl._losses(p, fz, b, TASK)
        return total, (metrics, spy.seen[-1])

    jl.model = spy
    try:
        (total, (metrics, forward)), grads = jax.jit(jax.value_and_grad(losses, has_aux=True))(
            pools, frozen, jb)
    finally:
        jl.model = spy.model
    flat, language, vis_p, txt_p = forward
    tl = tgl.GroundingLearner(_tiny(tc, kind), task_sim_matrix=np.eye(3),
                              init_params=params_from_jax(jax.tree.map(np.asarray, jl.params),
                                                          depths=(2, 2, 2, 2)),
                              device="cpu")
    return dict(kind=kind, jl=jl, tl=tl, batch=batch, flat=flat, language=language,
                vis_p=vis_p, txt_p=txt_p, total=total, metrics=metrics,
                grads=_torch_names(grads), jpools=pools)


def test_pool_and_encoder_match_the_config(pair):
    """The pool the config names, no interaction module (`interact:
    false`), the pool leaves as the JAX learner's, frozen elsewhere."""
    tl, kind = pair["tl"], pair["kind"]
    assert isinstance(tl.model.prompts, NormalPromptPool if kind == "sprompts"
                      else MaPLePromptPool)
    assert tl.model.encoder.interact is None
    assert set(tl.pools) == POOLS[kind] == set(_torch_names(pair["jpools"]))
    assert tl.pools["prompts.textual" if kind == "maple" else "prompts.textual_prompt"].shape \
        == (3, 6, 4, 16)
    if kind == "maple":
        assert tl.pools["prompts.proj_kernel"].shape == (3, 6, 16, 8)
        assert tl.pools["prompts.proj_bias"].shape == (3, 6, 8)
    assert not any(p.requires_grad for p in tl.frozen.values())


def test_train_and_eval_forwards_match_jax(pair):
    """The train forward at task 1 (head outputs, language features, the
    prompts) against JAX's; `forward_tasks` with per-sample tasks [1, 2]
    against the train forward of each sample's task (each sample's outputs
    depend on it alone, and there is no interaction module to follow the
    first sample's task)."""
    tl = pair["tl"]
    b = tl.to_device(pair["batch"])
    with torch.no_grad():
        flat, language, vis_p, txt_p = tl.model(b["images"], b["input_ids"],
                                                b["attention_mask"], torch.tensor(TASK))
        flat2, language2, _, _ = tl.model(b["images"], b["input_ids"], b["attention_mask"], 2)
        tflat, tlang = tl.model.forward_tasks(b["images"], b["input_ids"], b["attention_mask"],
                                              torch.tensor([1, 2]))
    for key in ("bbox_pred", "centerness", "dot_logits", "anchors"):
        _assert_close(flat[key].numpy(), np.asarray(pair["flat"][key]))
    for key in ("embedded", "aggregate"):
        _assert_close(language[key].numpy(), np.asarray(pair["language"][key]))
    _assert_close(vis_p.numpy(), np.asarray(pair["vis_p"]))
    _assert_close(txt_p.numpy(), np.asarray(pair["txt_p"]))
    for i, (f, lang) in enumerate(((flat, language), (flat2, language2))):
        for key in ("bbox_pred", "centerness", "dot_logits"):
            _assert_close(tflat[key][i].numpy(), f[key][i].numpy())
        _assert_close(tlang["embedded"][i].numpy(), lang["embedded"][i].numpy())
    # the prompts reach the outputs: task 2's differ from task 1's
    assert not torch.equal(flat2["dot_logits"][1], flat["dot_logits"][1])


def test_losses_and_pool_gradients_match_jax(pair):
    """JAX's metric keys (the auxiliary losses with MaPLe, whose config
    keeps them on; none with S-Prompts), each term, the total, and the
    gradient of every pool leaf, each and concatenated."""
    tl, kind = pair["tl"], pair["kind"]
    total, metrics = tl._losses(tl.to_device(pair["batch"]), TASK)
    want = pair["metrics"]
    assert set(metrics) == set(want) == KEYS[kind]
    assert metrics["num_pos"].item() == float(want["num_pos"]) > 0
    for key in KEYS[kind] - {"num_pos"}:
        _assert_close(np.float64(metrics[key].item()), np.float64(want[key]))
    _assert_close(np.float64(total.item()), np.float64(pair["total"]))
    names = sorted(tl.pools)
    grads = torch.autograd.grad(total, [tl.pools[n] for n in names])
    _assert_close(np.concatenate([g.numpy().ravel() for g in grads]),
                  np.concatenate([pair["grads"][n].numpy().ravel() for n in names]))
    for n, g in zip(names, grads):
        _assert_close(g.numpy(), pair["grads"][n].numpy())
        assert g[TASK].abs().sum() > 0 and g[2].abs().sum() == 0, n
    if kind == "maple":
        assert float(want["task_loss"]) > 0


def test_masked_clip_adamw_step_matches_optax(pair):
    """One step at task 1 from equal states against the JAX learner's step
    written out on JAX's gradients (one-hot, global-norm clip over the new
    leaves, AdamW, one-hot on the updates): the task-1 rows within the bar,
    every other row and every frozen parameter bit-equal."""
    jl, tl = pair["jl"], pair["tl"]
    cfg = jl.cfg
    pools = pair["jpools"]  # flat, by path tuple
    grads = {path: jnp.asarray(pair["grads"][".".join(path)].numpy()) for path in pools}
    onehot = {k: jax.nn.one_hot(TASK, v.shape[0]).reshape((v.shape[0],) + (1,) * (v.ndim - 1))
              for k, v in pools.items()}
    tx = jl._tx()
    clip_state, inj = tx.init(pools)
    lr = cfg.lr  # epoch 0 of one
    inj = inj._replace(hyperparams=dict(inj.hyperparams, learning_rate=jnp.float32(lr)))
    upd, _ = tx.update({k: g * onehot[k] for k, g in grads.items()}, (clip_state, inj), pools)
    want = optax.apply_updates(pools, {k: u * onehot[k] for k, u in upd.items()})
    want = _torch_names(want)

    start = {n: p.detach().clone() for n, p in tl.model.named_parameters()}
    tl.make_step(TASK, steps_per_epoch=1, epochs=1)(pair["batch"])
    try:
        for name, p in tl.model.named_parameters():
            if name in tl.pools:
                assert torch.equal(p[[0, 2]], start[name][[0, 2]]), name
                assert not torch.equal(p[TASK], start[name][TASK]), name
                _assert_close(p[TASK].detach().numpy(), want[name][TASK].numpy())
            else:
                assert torch.equal(p, start[name]), name
    finally:
        with torch.no_grad():
            for name, p in tl.model.named_parameters():
                p.copy_(start[name])


def test_predictor_serves_each_pool(pair):
    """`GroundingPredictor` on the port's model (eagerly, on the CPU): the
    task keys put task 2's centres on the served image's own frozen
    features, so the request takes task 2's prompts (`all_prompts`, then a
    gather) and returns finite detections."""
    import dataclasses

    from lpi_tpu_torch.continual.keys import TaskKeys
    from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
    from lpi_tpu_torch.serve.predictor import GroundingPredictor

    tl = pair["tl"]
    cfg = tl.cfg
    rng = np.random.RandomState(5)
    image = rng.randint(0, 256, (40, 48, 3)).astype(np.uint8)
    predictor = GroundingPredictor(tl.model, None, BertTokenizer(max_len=16, vocab_size=512),
                                   image_size=SIZE, score_thresh=0.0,
                                   atss_cfg=dataclasses.replace(cfg.atss, inference_thresh=0.0),
                                   device="cpu")
    canvas, _ = predictor._prepare_image(image)
    own = tl.extract_features(canvas)[0]
    others = tl.extract_features(rng.randn(2, SIZE, SIZE, 3).astype(np.float32))
    centers = torch.stack([others[0], others[1], own])[:, None].expand(3, 2, -1).contiguous()
    predictor.keys = TaskKeys(centers, torch.ones(3, dtype=torch.bool))
    result = predictor.predict(image, "a red car next to a dog")
    assert result["task_id"] == 2
    assert len(result["boxes"]) > 0 and np.isfinite(result["boxes"]).all()
    assert np.isfinite(result["scores"]).all()


def test_checkpoint_round_trip_and_restore(pair, tmp_path):
    """The port's checkpoint of the baseline's pools and keys, restored in
    place into a learner seeded otherwise: every tensor bit-equal, each in
    its own storage."""
    from lpi_tpu_torch.continual.keys import TaskKeys

    tl, kind = pair["tl"], pair["kind"]
    ck = SessionCheckpointer(str(tmp_path))
    keys = TaskKeys.create(3, 2, 5).update(0, torch.randn(2, 5, generator=torch.Generator()
                                                          .manual_seed(0)))
    ck.save_base(tl.frozen)
    ck.save_session(0, tl.pools, visual_keys=keys)
    other = tgl.GroundingLearner(_tiny(tc, kind), task_sim_matrix=np.eye(3),
                                 generator=torch.Generator().manual_seed(99), device="cpu")
    ptrs = {n: p.data_ptr() for n, p in other.model.named_parameters()}
    assert not torch.equal(other.pools["prompts.textual" if kind == "maple"
                                       else "prompts.visual_prompt"],
                           tl.pools["prompts.textual" if kind == "maple"
                                    else "prompts.visual_prompt"])
    assert other.restore(ck) == 0
    theirs = dict(tl.model.named_parameters())
    for n, p in other.model.named_parameters():
        assert torch.equal(p, theirs[n]) and p.data_ptr() == ptrs[n], n
    assert torch.equal(other.keys.centers, keys.centers)


def test_bridge_copies_the_pool_leaves_as_they_are(pair):
    """`proj_kernel` is 4-D but not named `kernel`: the bridge copies it
    untransposed, as every other pool leaf."""
    flat = pair["jpools"]  # flat, by path tuple
    state = params_from_jax(traverse_util.unflatten_dict(
        {k: np.asarray(v) for k, v in flat.items()}), depths=(2, 2, 2, 2))
    for path, v in flat.items():
        name = ".".join(path)
        assert tuple(state[name].shape) == tuple(v.shape), name
        np.testing.assert_array_equal(state[name].numpy(), np.asarray(v))


def test_converter_reports_baseline_pool_keys_unmapped():
    """A reference checkpoint's MaPLe and S-Prompts pools map nowhere in
    either converter: both report them unmapped, in the same order."""
    from tests.test_glip_convert import TINY as J_GLIP_TINY
    from tests.test_glip_convert import synthetic_glip_sd

    sd = synthetic_glip_sd(J_GLIP_TINY, np.random.RandomState(0))
    rng = np.random.RandomState(1)
    extra = []
    for t in range(2):
        extra += [f"module.prompts.{t}.textual_prompt", f"module.prompts.{t}.visual_prompt"]
        extra += [f"module.prompts.{t}.proj.{i}.{w}" for i in range(2) for w in ("weight",
                                                                                 "bias")]
    for k in extra:
        sd[k] = rng.randn(3, 4).astype(np.float32)
    _, junmapped = jglip.convert_glip(sd)
    got, unmapped = tglip.convert_glip(sd)
    assert unmapped == junmapped
    assert sorted(unmapped) == sorted(k[len("module."):] for k in extra)
    assert not any(k.startswith("prompts.") for k in got)


def test_train_grounding_command_runs_maple(tmp_path):
    """`train-grounding --synthetic --tasks 2 --epochs 1` on the CPU at the
    tiny config of `tests/test_torch_cli.py` merged with `maple.json`: both
    tasks train (finite losses, the auxiliary ones included), evaluate and
    save; the checkpoint holds MaPLe's leaves; `eval-all --grounding`
    restores each task into a learner seeded 99 and gives the training
    run's numbers."""
    from lpi_tpu_torch.cli import main as cli
    from tests.test_torch_cli import CONFIG

    grounding = dict(CONFIG["grounding"])
    grounding["lpi"] = {**grounding["lpi"], **lpi_section("maple")}
    config, config99 = tmp_path / "config.json", tmp_path / "config99.json"
    config.write_text(json.dumps({"grounding": grounding}))
    config99.write_text(json.dumps({"grounding": dict(grounding, seed=99)}))
    ck = str(tmp_path / "ck")
    path, learner = cli.main(["--platform", "cpu", "train-grounding", "--config", str(config),
                              "--synthetic", "--tasks", "2", "--epochs", "1", "--output-dir",
                              str(tmp_path / "res"), "--checkpoint-dir", ck])
    assert set(learner.pools) == POOLS["maple"]
    with open(os.path.join(tmp_path, "res", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 2
    for row in rows:
        for k in ("total", "alignment_loss", "task_loss", "loss_dot_product_token"):
            assert np.isfinite(row[k]), k
    with open(path) as f:
        results = json.load(f)
    state = torch.load(os.path.join(ck, "session_1", "state.pt"), weights_only=True)
    assert set(state["pool_params"]) == POOLS["maple"]
    out = cli.main(["--platform", "cpu", "eval-all", "--config", str(config99), "--grounding",
                    "--synthetic", "--checkpoint-dir", ck])
    for s, res in out.items():
        assert res["overall"] == results[str(s)]["overall"]
        assert res["task_id_accuracy"] == results[str(s)]["task_id_accuracy"]
