"""The continual-retrieval train path: the port against the JAX package.

The host data (tokenizer, synthetic sets, task relation) must give equal
arrays. The learners: one tiny JAX `RetrievalLearner` (the retrieval
gate's config, `bench.py:180-189`, fp32) is built per module with a
non-identity task-similarity matrix, and its weights are carried into the
port's learner by `bridge.slinet_params_from_jax`. The losses and their
pool gradient, two masked SGD steps and three `pretrain` steps are held to
the repo's bar (`_assert_close`: relative Frobenius 1e-4 and an absolute
cap of 3e-3); the slices the step must not move are held bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lpi_tpu.continual import learner as jlearner
from lpi_tpu.continual import mid as jmid
from lpi_tpu.core import config as jc
from lpi_tpu.data import retrieval as jdata
from lpi_tpu.data import tokenizer as jtok
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.bridge import slinet_params_from_jax
from lpi_tpu_torch.continual import learner as tlearner
from lpi_tpu_torch.continual import mid as tmid
from lpi_tpu_torch.data import retrieval as tdata
from lpi_tpu_torch.data import tokenizer as ttok
from tests.test_composed_parity import _assert_close

torch.set_num_threads(1)
TASK = 2
# tasks 0 and 2 related (0.5 > 0.4), 1 alone: the inter-task loss sees a
# positive pair at task 2
SIM = np.array([[1.0, 0.1, 0.5], [0.1, 1.0, 0.2], [0.5, 0.2, 1.0]], np.float32)


def _cfg(c):
    return c.RetrievalConfig(
        clip=c.CLIPConfig(image_resolution=32, patch_size=8, vision_width=64,
                          vision_layers=3, vision_heads=4, text_width=64, text_layers=3,
                          text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
                          n_ctx=4),
        lpi=c.LPIPromptConfig(prompt_length=4, prompt_depth=3, prompt_rank=2),
        total_sessions=3, epochs=4, batch_size=8, lr=0.05, visual_dim=64, textual_dim=64,
        num_key_clusters=2, dtype="float32")


def _torch_names(tree) -> dict:
    """A JAX params tree (nested or flat by path tuple) -> {torch name: tensor}."""
    if any(isinstance(k, tuple) for k in tree):
        tree = traverse_util.unflatten_dict(tree)
    return slinet_params_from_jax(jax.tree.map(np.asarray, tree))


def _learners(sim=SIM):
    """(JAX learner, the port's learner on its weights, on the CPU)."""
    jl = jlearner.RetrievalLearner(_cfg(jc), task_sim_matrix=sim)
    tl = tlearner.RetrievalLearner(_cfg(tc), task_sim_matrix=sim,
                                   init_params=_torch_names(jl.params), device="cpu")
    return jl, tl


def _session(task, n=16, seed=0):
    return jdata.synthetic_correlated_session(task, n, 32, jtok.ClipTokenizer(), 4, seed=seed)


@pytest.fixture(scope="module")
def pair():
    return _learners()


# ---- host data ------------------------------------------------------------
TEXTS = ["A photo of a dog's toy, 2 cats & 3½ birds!", "  multiple   spaces\tand\nlines ",
         "ÉCOLE naïve café 中文 <|startoftext|> x'll", "", "x" * 200]


def test_tokenizer_matches_jax():
    j, t = jtok.ClipTokenizer(), ttok.ClipTokenizer()
    assert t.vocab_size == j.vocab_size and (t.sot, t.eot) == (j.sot, j.eot)
    np.testing.assert_array_equal(t(TEXTS), j(TEXTS))
    np.testing.assert_array_equal(t.tokenize_with_prefix(TEXTS, 16),
                                  j.tokenize_with_prefix(TEXTS, 16))
    assert t.decode(t.encode(TEXTS[0])) == j.decode(j.encode(TEXTS[0]))
    for text in TEXTS:
        assert ttok.pre_caption(text, 5) == jtok.pre_caption(text, 5)


def _same_set(a, b):
    for field in dataclasses.fields(a):
        x, y = getattr(a, field.name), getattr(b, field.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, field.name


@pytest.mark.parametrize("name,args", [
    ("synthetic_session", (2, 12, 32)),
    ("synthetic_correlated_session", (1, 20, 32)),
    ("synthetic_correlated_pretrain", (3, 6, 32)),
    ("synthetic_correlated_eval", (2, 8, 32)),
    ("synthetic_eval", (3, 4, 2, 32)),
])
def test_synthetic_sets_match_jax(name, args):
    _same_set(getattr(tdata, name)(*args, tokenizer=ttok.ClipTokenizer(), n_ctx=4),
              getattr(jdata, name)(*args, tokenizer=jtok.ClipTokenizer(), n_ctx=4))


def test_batches_and_eval_batches_match_jax():
    jset = _session(1, 19)
    tset = tdata.RetrievalTrainSet(jset.images, jset.token_ids, jset.task_index)
    for drop in (True, False):
        for a, b in zip(tset.batches(8, seed=5, drop_remainder=drop),
                        jset.batches(8, seed=5, drop_remainder=drop), strict=True):
            for k in ("images", "token_ids"):
                np.testing.assert_array_equal(a[k], b[k])
    jev = jdata.synthetic_eval(2, 5, 2, 32, jtok.ClipTokenizer(), 4)
    tev = tdata.RetrievalEvalSet(**{f.name: getattr(jev, f.name)
                                    for f in dataclasses.fields(jev)})
    for it in ("image_batches", "text_batches"):
        for (a, n), (b, m) in zip(getattr(tev, it)(4), getattr(jev, it)(4), strict=True):
            assert n == m
            np.testing.assert_array_equal(a, b)


def test_task_relation_matches_jax():
    fb = tmid.fallback_sim_matrix(12)
    np.testing.assert_array_equal(fb, jmid.fallback_sim_matrix(12))
    for sim in (SIM, fb):
        np.testing.assert_array_equal(tmid.task_relation(sim), jmid.task_relation(sim))
    assert tmid.TASK_NAMES == jmid.TASK_NAMES


# ---- the losses and their gradient ----------------------------------------
@pytest.fixture(scope="module")
def jax_losses(pair):
    """The JAX `_losses` and its pool gradient at tasks 0 and 2 on one
    batch, one compiled function (the task id traced)."""
    jl, _ = pair
    batch = next(_session(TASK).batches(8, seed=1))
    pools, frozen = jlearner._split_params(jl.params)
    fn = jax.jit(jax.value_and_grad(jl._losses, has_aux=True))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return batch, {t: fn(pools, frozen, jb, t) for t in (0, TASK)}


@pytest.mark.parametrize("task", [0, TASK])
def test_losses_match_jax(pair, jax_losses, task):
    """base (batch-global InfoNCE), alignment (x0.1) and inter-task (x0.1,
    masked to tasks 0..task, 0 at task 0) terms and the total, with the task
    id as a device tensor as the step passes it."""
    _, tl = pair
    batch, res = jax_losses
    (jtotal, jterms), _ = res[task]
    with torch.no_grad():
        total, terms = tl._losses(tl.to_device(batch), torch.tensor(task))
    assert set(terms) == set(jterms) == {"base_loss", "alignment_loss", "task_loss"}
    for k in terms:
        _assert_close(terms[k].numpy(), np.asarray(jterms[k]))
    _assert_close(total.numpy(), np.asarray(jtotal))
    if task == 0:
        assert float(terms["task_loss"]) == 0.0
    else:
        assert float(terms["task_loss"]) > 0.0


@pytest.mark.parametrize("task", [0, TASK])
def test_pool_gradient_matches_jax(pair, jax_losses, task):
    """The gradient of the total with respect to every pool leaf, every
    task's slice (the task loss reaches the other tasks' factors); ctx_pool
    gets none in either package."""
    _, tl = pair
    batch, res = jax_losses
    _, jgrads = res[task]
    jgrads = _torch_names(jgrads)
    names = sorted(tl.pools)
    total, _ = tl._losses(tl.to_device(batch), torch.tensor(task))
    grads = dict(zip(names, torch.autograd.grad(total, [tl.pools[n] for n in names],
                                                allow_unused=True)))
    assert grads["ctx_pool"] is None and not np.any(jgrads["ctx_pool"].numpy())
    names.remove("ctx_pool")
    _assert_close(np.concatenate([grads[n].numpy().ravel() for n in names]),
                  np.concatenate([jgrads[n].numpy().ravel() for n in names]))
    if task == TASK:  # the inter-task loss moves task 0's factors too
        assert np.abs(grads["prompts.d3_visual"][0].numpy()).max() > 0


# ---- the step ---------------------------------------------------------------
def test_two_masked_sgd_steps_match_jax(pair):
    """Two steps of a session at task 2 (one step an epoch, so the second
    takes epoch 1's cosine lr) from equal states: the task-2 slices match
    JAX's, every other slice of every pool is bit-equal to its start, the
    towers are untouched and `ctx_pool`'s task-2 slice decays as in JAX."""
    jl, tl = pair
    ds = _session(TASK)
    batches = list(ds.batches(8, seed=3))[:2]
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
        for k in ("total", "base_loss", "alignment_loss", "task_loss"):
            _assert_close(m[k].numpy(), np.asarray(jm[k]))
    others = [t for t in range(3) if t != TASK]
    for name, p in tl.model.named_parameters():
        if name in tl.pools:
            assert torch.equal(p[others], start[name][others]), name
            assert not torch.equal(p[TASK], start[name][TASK]), name
            _assert_close(p[TASK].detach().numpy(), want[name][TASK].numpy())
        else:
            assert torch.equal(p, start[name]), name
    # ctx_pool: no gradient, so wd decays its slice: lr1 and lr2 by epoch
    cfg = tl.cfg
    lr = [cfg.lr, cfg.lr * 0.5]
    c0 = start["ctx_pool"][TASK].numpy()
    t1 = cfg.weight_decay * c0
    c1 = c0 - lr[0] * t1
    c2 = c1 - lr[1] * (cfg.weight_decay * c1 + cfg.momentum * t1)
    _assert_close(tl.model.ctx_pool[TASK].detach().numpy(), c2)
    assert not np.array_equal(c2, c0)


def test_pretrain_three_steps_match_jax(pair):
    """Three full-parameter steps at task 0 (global-norm clip 1.0, AdamW
    without decay, lr 1e-3) from equal weights: the losses of the last step
    and every parameter. Adam divides each gradient entry by its magnitude
    plus 1e-8, so an entry whose first (clipped) gradient lies within 1e-6
    of zero
    (the attention key biases, whose gradient is zero in exact arithmetic,
    and nearly dead units) steps by an amount that rounding noise decides:
    those entries are held to Adam's step bound instead, the rest of each
    parameter to the repo's bar. The bound: a bias-corrected Adam step is
    lr |m_hat| / sqrt(v_hat), and by Cauchy-Schwarz over the two moments'
    weights |m_hat| / sqrt(v_hat) <= 1, 1.0014 and 1.0036 at steps 1-3, so
    three steps move an entry by at most 3 lr x 1.004."""
    jl0, _ = pair
    ds = jdata.synthetic_correlated_pretrain(3, 6, 32, jtok.ClipTokenizer(), 4)
    saved = jl0.params
    jl0.params = jax.tree.map(jnp.array, saved)  # pretrain donates them
    tl = tlearner.RetrievalLearner(_cfg(tc), task_sim_matrix=SIM,
                                   init_params=_torch_names(saved), device="cpu")
    try:
        jm = jl0.pretrain(ds, steps=3, lr=1e-3)
        want = _torch_names(jl0.params)
    finally:
        jl0.params = saved
    tds = tdata.RetrievalTrainSet(ds.images, ds.token_ids, 0)
    named = dict(tl.model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    total, _ = tl._losses(tl.to_device(next(tds.batches(8, seed=tl.cfg.seed))), 0)
    grads = dict(zip(named, torch.autograd.grad(total, list(named.values()),
                                                allow_unused=True)))
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values() if g is not None))
    clip = min(1.0, 1.0 / float(norm))  # the first step's global-norm clip
    start = {n: p.detach().clone() for n, p in named.items()}
    got = tl.pretrain(tds, steps=3, lr=1e-3)
    for k in jm:
        _assert_close(got[k], jm[k])
    state = tl.model.state_dict()
    assert set(state) == set(want)
    noisy = 0
    for name in sorted(want):
        g = grads[name]
        steady = (np.ones(state[name].numel(), bool) if g is None
                  else clip * g.abs().numpy().reshape(-1) >= 1e-6)
        noisy += int((~steady).sum()) if name.endswith("in_proj.bias") else 0
        _assert_close(state[name].numpy().reshape(-1)[steady],
                      want[name].numpy().reshape(-1)[steady])
        for p in (state[name], want[name]):  # Adam's step bound, below
            assert (p - start[name]).abs().max() <= 3 * 1e-3 * 1.004, name
    assert noisy >= 3 * 2 * 64  # every key bias of both 3-layer towers (width 64)
    assert all(p.requires_grad for p in tl.pools.values())
    assert not any(p.requires_grad for p in tl.frozen.values())


def test_pool_split_freezes_the_towers(pair, tmp_path):
    """The pools and the frozen towers; `restore` (ported since) refuses a
    directory without sessions (`tests/test_torch_checkpoint.py` holds the
    rest of it)."""
    from lpi_tpu_torch.core.checkpoint import SessionCheckpointer

    _, tl = pair
    assert set(tl.pools) == {"ctx_pool", "prompts.d1_share", "prompts.d2_visual",
                             "prompts.d2_textual", "prompts.d3_visual", "prompts.d3_textual"}
    assert not any(p.requires_grad for p in tl.frozen.values())
    with pytest.raises(ValueError, match="no sessions"):
        tl.restore(SessionCheckpointer(tmp_path))
