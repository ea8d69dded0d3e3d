"""The retrieval baselines (S-Prompts, L2P, zero-shot CLIP): the port
against the JAX package.

Each type's tiny learner (`tests/test_torch_clip.py`'s CLIP at 32 px,
patch 8, 17 image tokens, width 64, two layers a tower; 3 sessions, fp32)
is built in JAX with the lpi section of `configs/baselines/{type}.json`
(`prompt_type="clip"` for CLIP) and its weights carried into the port by
`bridge.slinet_params_from_jax`. Inputs come from numpy seeds. The SliNet
forward, `_losses` (the same keys as JAX's), the pool gradients and two
masked SGD steps are held to the repo's bar (relative Frobenius 1e-4 and
an absolute cap of 3e-3); the slices and towers a step must not move are
held bit for bit; `evaluate` gives JAX's task ids, ranks and R@k
exactly. Then `train --synthetic` on the command line, on the CPU.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.continual import learner as jlearner
from lpi_tpu.core import config as jc
from lpi_tpu.data import retrieval as jdata
from lpi_tpu.data.tokenizer import ClipTokenizer as JTok
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.bridge import keys_from_jax
from lpi_tpu_torch.continual import learner as tlearner
from lpi_tpu_torch.data import retrieval as tdata
from lpi_tpu_torch.data.tokenizer import ClipTokenizer
from lpi_tpu_torch.models.clip.slinet import L2P_EVAL_GAP
from tests.test_composed_parity import _assert_close
from tests.test_torch_retrieval import SIM, _torch_names

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK = 2
KINDS = ("sprompts", "l2p", "clip")
# the loss terms of each type: the auxiliary losses are "lpi"'s alone
KEYS = {"sprompts": {"base_loss"}, "l2p": {"base_loss"}, "clip": {"base_loss"}}
POOLS = {"sprompts": {"ctx_pool", "prompts.visual_prompt", "prompts.textual_prompt"},
         "l2p": {"ctx_pool", "prompts.prompt", "prompts.prompt_key"},
         "clip": {"ctx_pool"}}


def lpi_section(kind) -> dict:
    """The baseline's retrieval lpi overrides (`prompt_type="clip"` for
    zero-shot CLIP, which has no config file)."""
    if kind == "clip":
        return {"prompt_type": "clip"}
    with open(os.path.join(REPO, "configs", "baselines", f"{kind}.json")) as f:
        return json.load(f)["retrieval"]["lpi"]


def _cfg(c, kind, **lpi):
    return c.RetrievalConfig(
        clip=c.CLIPConfig(image_resolution=32, patch_size=8, vision_width=64,
                          vision_layers=2, vision_heads=4, text_width=64, text_layers=2,
                          text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
                          n_ctx=4),
        lpi=c.LPIPromptConfig(prompt_length=4, prompt_depth=3, prompt_rank=2,
                              **{**lpi_section(kind), **lpi}),
        total_sessions=3, epochs=4, batch_size=8, lr=0.05, visual_dim=64, textual_dim=64,
        num_key_clusters=2, dtype="float32")


def _session(task, n=16, seed=0):
    return jdata.synthetic_correlated_session(task, n, 32, JTok(), 4, seed=seed)


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    """(kind, JAX learner, the port's learner on its weights, one batch,
    JAX's losses and pool gradient at task 2 on it)."""
    kind = request.param
    jl = jlearner.RetrievalLearner(_cfg(jc, kind), task_sim_matrix=SIM)
    tl = tlearner.RetrievalLearner(_cfg(tc, kind), task_sim_matrix=SIM,
                                   init_params=_torch_names(jl.params), device="cpu")
    batch = next(_session(TASK).batches(8, seed=1))
    pools, frozen = jlearner._split_params(jl.params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (total, terms), grads = jax.jit(jax.value_and_grad(jl._losses, has_aux=True),
                                    static_argnums=3)(pools, frozen, jb, TASK)
    return dict(kind=kind, jl=jl, tl=tl, batch=batch, total=total, terms=terms,
                grads=_torch_names(grads))


def test_pools_and_forward_match_jax(pair):
    """The pool split, and the train forward at task 2: both feature sets,
    the prompts (zeros [1, 1, D] for L2P and CLIP) and the logit scale."""
    jl, tl, kind = pair["jl"], pair["tl"], pair["kind"]
    assert set(tl.pools) == POOLS[kind]
    assert not any(p.requires_grad for p in tl.frozen.values())
    images, ids = pair["batch"]["images"], pair["batch"]["token_ids"]
    want = jl.model.apply({"params": jl.params}, jnp.asarray(images), jnp.asarray(ids), TASK)
    b = tl.to_device(pair["batch"])
    with torch.no_grad():
        got = tl.model(b["images"], b["token_ids"], torch.tensor(TASK))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w))
        _assert_close(g.numpy(), np.asarray(w))
    if kind in ("l2p", "clip"):
        assert not got[2].any() and got[2].shape == (1, 1, 64)


def test_losses_and_pool_gradients_match_jax(pair):
    """JAX's loss keys, each term and the total; the gradient of every pool
    leaf that the forward reads (None in the port where JAX's is zero:
    `ctx_pool` but for L2P, L2P's keys)."""
    tl, kind = pair["tl"], pair["kind"]
    total, terms = tl._losses(tl.to_device(pair["batch"]), torch.tensor(TASK))
    assert set(terms) == set(pair["terms"]) == KEYS[kind]
    for k in terms:
        _assert_close(terms[k].detach().numpy(), np.asarray(pair["terms"][k]))
    _assert_close(total.detach().numpy(), np.asarray(pair["total"]))
    names = sorted(tl.pools)
    assert total.requires_grad == (kind != "clip")  # CLIP's loss reads no pool leaf
    grads = dict(zip(names, torch.autograd.grad(total, [tl.pools[n] for n in names],
                                                allow_unused=True)
                     if total.requires_grad else [None] * len(names)))
    want = pair["grads"]
    live = [n for n in names if grads[n] is not None]
    for n in names:
        if grads[n] is None:
            assert not np.any(want[n].numpy()), n
    assert set(live) == {"sprompts": {"prompts.visual_prompt", "prompts.textual_prompt"},
                         "l2p": {"ctx_pool", "prompts.prompt"}, "clip": set()}[kind]
    if live:
        _assert_close(np.concatenate([grads[n].numpy().ravel() for n in live]),
                      np.concatenate([want[n].numpy().ravel() for n in live]))
    for n in live:  # a per-task pool's gradient is its task's row alone
        others = [t for t in range(3) if t != TASK]
        if n != "prompts.prompt":
            assert not grads[n][others].any(), n
    if kind == "l2p":  # the shared pool: the rows the vote chose
        chosen = grads["prompts.prompt"].abs().sum((1, 2)) > 0
        assert 0 < int(chosen.sum()) <= tl.cfg.lpi.l2p_top_k


def test_two_masked_sgd_steps_match_jax(pair):
    """Two steps at task 2 (one step an epoch, so the second takes epoch
    1's cosine lr) from equal states: the metrics and the task-2 slices
    match JAX's; every other slice of every pool (L2P's shared pool and
    keys included) and every tower parameter are bit-equal to their start."""
    jl, tl = pair["jl"], pair["tl"]
    batches = list(_session(TASK).batches(8, seed=3))[:2]
    tx, jstep = jl._make_train_step(TASK, steps_per_epoch=1, epochs=2)
    pools, frozen = jlearner._split_params(jl.params)
    pools = jax.tree.map(jnp.array, pools)  # the step donates its inputs
    opt_state = tx.init(pools)
    jmetrics = []
    for b in batches:
        pools, opt_state, m = jstep(pools, opt_state, frozen,
                                    {k: jnp.asarray(v) for k, v in b.items()})
        jmetrics.append(m)
    want = _torch_names(pools)

    start = {n: p.detach().clone() for n, p in tl.model.named_parameters()}
    step = tl.make_train_step(TASK, steps_per_epoch=1, epochs=2)
    metrics = [step(b) for b in batches]
    for m, jm in zip(metrics, jmetrics):
        assert set(m) == set(jm)
        for k in m:
            _assert_close(m[k].numpy(), np.asarray(jm[k]))
    others = [t for t in range(3) if t != TASK]
    for name, p in tl.model.named_parameters():
        if name in tl.pools:
            assert torch.equal(p[others], start[name][others]), name
            assert not torch.equal(p[TASK], start[name][TASK]), name  # the decay, at least
            _assert_close(p[TASK].detach().numpy(), want[name][TASK].numpy())
        else:
            assert torch.equal(p, start[name]), name
    with torch.no_grad():  # the module's later tests start from the same weights
        for name, p in tl.model.named_parameters():
            p.copy_(start[name])


def test_evaluate_matches_jax_or_raises_as_jax_does(pair):
    """`evaluate` on a 3-task set after keys for three sessions (JAX's,
    carried): S-Prompts infers each sample's task and gathers its prompts,
    CLIP ranks the frozen features with every sample at task 0; task-ID
    accuracies, per-task R@k and the summary equal JAX's. L2P has no
    evaluation in the reference (its pool has no `all_prompts`): JAX raises
    an AttributeError and the port a NotImplementedError naming the gap."""
    jl, tl, kind = pair["jl"], pair["tl"], pair["kind"]
    for t in range(3):
        jl.cluster_task(_session(t, 12))
    tl.visual_keys = keys_from_jax(np.asarray(jl.visual_keys.centers),
                                   np.asarray(jl.visual_keys.valid))
    tl.textual_keys = keys_from_jax(np.asarray(jl.textual_keys.centers),
                                    np.asarray(jl.textual_keys.valid))
    jev = jdata.synthetic_correlated_eval(3, 8, 32, JTok(), 4)
    tev = tdata.synthetic_correlated_eval(3, 8, 32, ClipTokenizer(), 4)
    if kind == "l2p":
        with pytest.raises(AttributeError, match="all_prompts"):
            jl.evaluate(jev, num_tasks=3)
        with pytest.raises(NotImplementedError, match="ROADMAP C"):
            tl.evaluate(tev, num_tasks=3)
        return
    want = jl.evaluate(jev, num_tasks=3)
    got = tl.evaluate(tev, num_tasks=3)
    assert got["task_id_accuracy"] == want["task_id_accuracy"]
    assert got["i2t"] == want["i2t"] and got["t2i"] == want["t2i"]
    assert got["summary"] == pytest.approx(want["summary"], abs=0)
    if kind == "clip":  # every sample at task 0: a third of the set's samples
        assert got["task_id_accuracy"] == {"visual": 1 / 3, "textual": 1 / 3}


@pytest.mark.parametrize("kind", KINDS)
def test_train_command_runs_each_baseline(kind, tmp_path):
    """`train --synthetic --sessions 2 --epochs 1` on the CPU at the tiny
    config of `tests/test_torch_cli.py` merged with the baseline's lpi
    section: S-Prompts and CLIP run through both sessions, save them and
    evaluate each; L2P trains session 0 and stops at its evaluation with
    the named error, where the reference raises its AttributeError."""
    from lpi_tpu_torch.cli import main as cli
    from lpi_tpu_torch.core.checkpoint import SessionCheckpointer
    from tests.test_torch_cli import CONFIG

    config = tmp_path / "config.json"
    retrieval = dict(CONFIG["retrieval"])
    retrieval["lpi"] = {**retrieval["lpi"], **lpi_section(kind)}
    config.write_text(json.dumps({"retrieval": retrieval}))
    argv = ["--platform", "cpu", "train", "--config", str(config), "--synthetic",
            "--sessions", "2", "--epochs", "1", "--output-dir", str(tmp_path / "res"),
            "--checkpoint-dir", str(tmp_path / "ck")]
    if kind == "l2p":
        with pytest.raises(NotImplementedError, match="ROADMAP C") as err:
            cli.main(argv)
        assert str(err.value) == L2P_EVAL_GAP
        assert SessionCheckpointer(str(tmp_path / "ck")).latest_session() is None
        return
    path, learner = cli.main(argv)
    with open(path) as f:
        results = json.load(f)
    assert sorted(results) == ["0", "1"]
    for r in results.values():
        assert all(np.isfinite(v) for v in r["summary"].values())
    assert SessionCheckpointer(str(tmp_path / "ck")).latest_session() == 1
    assert set(learner.pools) == POOLS[kind]
    if kind == "clip":
        assert all(r["task_id_accuracy"]["visual"] == (1.0 if s == "0" else 0.5)
                   for s, r in results.items())


def test_l2p_shared_pool_is_masked_by_session(pair):
    """L2P's shared pool has one row per session ([sessions, length, D],
    keys [sessions, D]), so the one-hot over its leading axis is the
    session's: the step's masks have the pool's shape."""
    tl = pair["tl"]
    masks = dict(zip(tl.pools, tl._masks(torch.tensor(TASK))))
    for name, p in tl.pools.items():
        assert p.shape[0] == 3 and masks[name].shape == (3,) + (1,) * (p.dim() - 1), name
        assert masks[name].reshape(-1).tolist() == [0.0, 0.0, 1.0], name
    if pair["kind"] == "l2p":
        assert tl.pools["prompts.prompt"].shape == (3, 4, 64)
        assert tl.pools["prompts.prompt_key"].shape == (3, 64)
