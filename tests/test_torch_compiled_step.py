"""The session steps driven by device tensors, their in-place session reset,
`honest_offsets`, the grounding bench line and the capture helper's CPU
behaviour.

On the card the grounding and retrieval steps and the request are captured
as CUDA graphs and replayed (`lpi_tpu_torch.graphs`); a graph reads every
input it does not copy in (task id, lr, the AdamW bias corrections, the
optimizer state) at the address it had at capture, so these are 0-d
device tensors written in place, and one capture serves every session.
Here, on the CPU, the same step code runs eagerly: these tests hold it to
the host-driven step it replaced (the same bits), to optax and the JAX
package's SGD step, and check that a new session resets the state in place
and that the GIoU's product, rewritten without a read-back to the host,
keeps `torch.prod`'s gradient.
The card's own checks (captured against eager in bits, a replay reading
new offsets) are in `tests/test_torch_kernels_gpu.py`.
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
from lpi_tpu.continual import learner as jlearner
from lpi_tpu.core import config as jc
from lpi_tpu.models.glip.grounding import GroundedVLModel as JModel
from lpi_tpu_torch import config as tc
from lpi_tpu_torch import graphs
from lpi_tpu_torch.bench import bench_grounding, honest_offsets
from lpi_tpu_torch.bridge import params_from_jax
from lpi_tpu_torch.continual import common
from lpi_tpu_torch.continual import grounding_learner as tgl
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer
from lpi_tpu_torch.models.glip.grounding import GroundedVLModel
from lpi_tpu_torch.ops import boxes
from lpi_tpu_torch.serve.predictor import GroundingPredictor
from tests.test_composed_parity import _assert_close
from tests.test_torch_retrieval import _learners, _session
from tests.test_torch_retrieval import _torch_names as _retrieval_names
from tests.test_torch_train import _tasks, _tiny

torch.set_num_threads(1)
STEPS = 3


def _learner():
    return tgl.GroundingLearner(_tiny(tc), task_sim_matrix=np.eye(3),
                                generator=torch.Generator().manual_seed(1), device="cpu")


def _batches(task):
    """Three steps over a task's two batches of two."""
    b = list(_tasks(task).batches(2))
    return [b[0], b[1], b[0]]


def _host_driven_step(tl, batch, task_id: int, lr: float, state: dict):
    """The grounding step as it ran when the host drove it: a Python int
    task id whose one-hot is written row by row, a Python float lr, and
    the AdamW count and bias corrections kept on the host and passed to
    each op as Python scalars."""
    cfg = tl.cfg
    params = list(tl.pools.values())
    total, metrics = tl._losses(tl.to_device(batch), task_id)
    grads = torch.autograd.grad(total, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    masks = []
    for p in params:
        oh = torch.zeros(p.shape[0], dtype=p.dtype)
        oh[task_id] = 1.0
        masks.append(oh.reshape((-1,) + (1,) * (p.dim() - 1)))
    grads = common.clip_by_global_norm([g * mk for g, mk in zip(grads, masks)], cfg.grad_clip)
    state["count"] += 1
    b1, b2 = np.float32(common.ADAM_B1), np.float32(common.ADAM_B2)
    bc1 = float(np.float32(1) - b1 ** np.float32(state["count"]))
    bc2 = float(np.float32(1) - b2 ** np.float32(state["count"]))
    with torch.no_grad():
        for i, (p, g) in enumerate(zip(params, grads)):
            mu = (1 - common.ADAM_B1) * g + common.ADAM_B1 * state["mu"][i]
            nu = (1 - common.ADAM_B2) * (g * g) + common.ADAM_B2 * state["nu"][i]
            state["mu"][i], state["nu"][i] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + common.ADAM_EPS)
            u = -lr * (u + cfg.weight_decay * p)
            p.add_(u * masks[i])
    return {"total": total.detach(), **{k: v.detach() for k, v in metrics.items()}}


@pytest.mark.parametrize("task", [0, 2])
def test_tensor_driven_grounding_step_equals_the_host_driven_step(task):
    """Three steps of one session (one step an epoch, so each takes the next
    cosine lr) from equal weights: every metric and every pool leaf equal
    bit for bit after each step."""
    ours, theirs = _learner(), _learner()
    step = ours.make_step(task, steps_per_epoch=1, epochs=2)
    lrs = common.epoch_lrs(theirs.cfg.lr, 2)
    params = list(theirs.pools.values())
    state = {"count": 0, "mu": [torch.zeros_like(p) for p in params],
             "nu": [torch.zeros_like(p) for p in params]}
    for n, batch in enumerate(_batches(task)):
        got = step(batch)
        want = _host_driven_step(theirs, batch, task, lrs[min(n, 2)], state)
        for k in want:
            assert torch.equal(got[k], want[k]), (n, k)
        for name, p in ours.pools.items():
            assert torch.equal(p, theirs.pools[name]), (n, name)
    assert ours._session.state.count == STEPS
    assert ours._session.task_id.item() == task and ours._session.task_id.dim() == 0
    assert ours._session.lr.item() == np.float32(lrs[2])


@pytest.mark.parametrize("task", [0, 2])
def test_device_scalar_adamw_matches_optax(task):
    """Three masked steps with the lr and the bias corrections as 0-d
    tensors (the CPU's: the corrections themselves) and the one-hot built
    from a 0-d task id, against optax's
    `clip_by_global_norm` + `adamw` at `test_masked_clip_adamw_step_matches_optax`'s
    bar; the other tasks' rows never move."""
    rng = np.random.RandomState(task)
    cfg = tc.GroundingConfig()
    shapes = {"a": (3, 4, 5), "b": (3, 7)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    steps = [{k: (rng.randn(*s) * 10.0 ** (i - 1)).astype(np.float32)
              for k, s in shapes.items()} for i in range(STEPS)]
    lrs = [0.01, 0.005, 0.0025]
    tx = optax.chain(optax.clip_by_global_norm(cfg.grad_clip),
                     optax.inject_hyperparams(optax.adamw)(learning_rate=0.0,
                                                          weight_decay=cfg.weight_decay))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    onehot = {k: jax.nn.one_hot(task, 3).reshape((3,) + (1,) * (len(s) - 1))
              for k, s in shapes.items()}
    tp = [torch.from_numpy(params[k].copy()) for k in shapes]
    tid, lr = torch.tensor(task), torch.zeros(())
    state = common.AdamState.zeros(tp)
    for g, step_lr in zip(steps, lrs):
        clip_state, inj = jstate
        inj = inj._replace(hyperparams=dict(inj.hyperparams, learning_rate=jnp.float32(step_lr)))
        jg = {k: jnp.asarray(v) * onehot[k] for k, v in g.items()}
        upd, jstate = tx.update(jg, (clip_state, inj), jp)
        jp = optax.apply_updates(jp, {k: u * onehot[k] for k, u in upd.items()})
        masks = [(torch.arange(3) == tid).float().reshape((3,) + (1,) * (len(s) - 1))
                 for s in shapes.values()]
        lr.fill_(step_lr)
        state.advance()
        tg = [torch.from_numpy(g[k]) * mk for k, mk in zip(shapes, masks)]
        common.adamw_apply(tp, common.clip_by_global_norm(tg, cfg.grad_clip), state, lr,
                           cfg.weight_decay, masks)
        for k, t in zip(shapes, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
    others = [t for t in range(3) if t != task]
    for k, t in zip(shapes, tp):
        np.testing.assert_array_equal(t.numpy()[others], params[k][others])
    assert state.count == STEPS
    assert state.c1.item() == np.float32(1) - np.float32(common.ADAM_B1) ** np.float32(STEPS)


def test_two_grounding_sessions_through_one_builder_equal_fresh_state():
    """Tasks 0 then 2, two steps each, through the learner's one set of
    session inputs (reset in place by `make_step`) against the same with a
    fresh set for the second session: every parameter equal bit for bit,
    and the session buffers are the same tensors in both sessions."""
    ours, theirs = _learner(), _learner()
    for tl in (ours, theirs):
        step = tl.make_step(0, steps_per_epoch=1, epochs=2)
        for batch in _batches(0)[:2]:
            step(batch)
    buffers = [id(t) for t in (ours._session.task_id, ours._session.lr,
                               *ours._session.state.mu)]
    theirs._session = None
    for tl in (ours, theirs):
        step = tl.make_step(2, steps_per_epoch=1, epochs=2)
        for batch in _batches(2)[:2]:
            step(batch)
    assert buffers == [id(t) for t in (ours._session.task_id, ours._session.lr,
                                       *ours._session.state.mu)]
    assert ours._session.state.count == theirs._session.state.count == 2
    for name, p in ours.model.named_parameters():
        assert torch.equal(p, dict(theirs.model.named_parameters())[name]), name
    assert not ours._graphs  # the CPU never captures


def test_two_retrieval_sessions_through_one_builder_match_jax():
    """Sessions at tasks 0 and 2, two steps each (one step an epoch),
    through one learner's session inputs (momentum zeroed in place by
    `make_train_step`), against the JAX package's step with a fresh
    optimizer per session: every slice within the repo's bar, the towers
    untouched, task 1's slices bit-equal to their start."""
    jl, tl = _learners()
    start = {n: p.detach().clone() for n, p in tl.model.named_parameters()}
    pools, frozen = jlearner._split_params(jl.params)
    pools = jax.tree.map(jnp.array, pools)  # the step donates its inputs
    trace_ids = None
    for task in (0, 2):
        batches = list(_session(task).batches(8, seed=3))[:2]
        tx, jstep = jl._make_train_step(task, steps_per_epoch=1, epochs=2)
        opt_state = tx.init(pools)
        step = tl.make_train_step(task, steps_per_epoch=1, epochs=2)
        for b in batches:
            pools, opt_state, jm = jstep(pools, opt_state, frozen,
                                         {k: jnp.asarray(v) for k, v in b.items()})
            m = step(b)
            for k in ("total", "base_loss", "alignment_loss", "task_loss"):
                _assert_close(m[k].numpy(), np.asarray(jm[k]))
        ids = [id(t) for t in tl._session.trace]
        assert trace_ids in (None, ids)
        trace_ids = ids
    want = _retrieval_names(pools)
    for name, p in tl.model.named_parameters():
        if name in tl.pools:
            assert torch.equal(p[1], start[name][1]), name
            for task in (0, 2):
                _assert_close(p[task].detach().numpy(), want[name][task].numpy())
        else:
            assert torch.equal(p, start[name]), name
    assert not tl._graphs


def _reference_honest_offsets(params):
    """`bench.py:365-384`'s loop, copied (it sits inside `bench_grounding`),
    applied to a nested Flax parameter tree."""
    rng = np.random.RandomState(7)
    flat = traverse_util.flatten_dict(params)
    for k, v in flat.items():
        if "offset" in k:
            if k[-1] == "kernel":
                flat[k] = v * 30.0
            elif k[-1] == "bias":
                bias = np.zeros(v.shape, np.float32)
                bias[:18] = rng.randn(18) * 1.0
                flat[k] = jnp.asarray(bias)
    return traverse_util.unflatten_dict(flat)


def _eleven_towers(c):
    """`_tiny` with 11 towers of 16 channels: the jitted init sorts the
    tower keys (tower0, tower1, tower10, tower2, ...), which the draw order
    must follow."""
    cfg = _tiny(c)
    return dataclasses.replace(cfg, dyhead=dataclasses.replace(cfg.dyhead, num_convs=11,
                                                               channels=16))


def test_honest_offsets_equals_the_reference_loop_on_carried_weights():
    """The JAX package's Flax parameters (the tree a jitted init returns,
    filled with seeded values), the reference loop applied to them and
    carried across, against `honest_offsets` applied in place to the port's
    model holding the same carried weights: every parameter equal bit for
    bit, and the offset convs' parameters the same tensors as before."""
    jm = JModel(_eleven_towers(jc))
    shapes = jax.eval_shape(jax.jit(jm.init), jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 16), jnp.int32),
                            jnp.ones((1, 16)), 0)["params"]
    rng = np.random.RandomState(0)
    flax_params = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32) * 0.01,
                               shapes)
    assert [k for k in flax_params["head"] if k.startswith("tower")][:3] == \
        ["tower0", "tower1", "tower10"]
    model = GroundedVLModel(_eleven_towers(tc))
    model.load_state_dict(params_from_jax(flax_params, depths=(2, 2, 2, 2)), strict=True)
    storage = {n: p.data_ptr() for n, p in model.named_parameters() if ".offset." in n}
    honest_offsets(model)
    want = params_from_jax(jax.tree.map(np.asarray, _reference_honest_offsets(flax_params)),
                           depths=(2, 2, 2, 2))
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), want[name]), name
    assert storage == {n: p.data_ptr() for n, p in model.named_parameters() if ".offset." in n}
    biases = [model.head.towers[i].offset.bias for i in range(11)]
    assert all(b[:18].abs().sum() > 0 and b[18:].abs().sum() == 0 for b in biases)


def test_reference_loop_matches_no_key_of_the_split_parameters():
    """`bench.py` applies its loop to `_split_params`' flat dict, whose keys
    are whole paths, so `"offset" in k` is never true there and its
    "honest" timing runs the seeded offsets; `honest_offsets` does what
    the loop means to."""
    params = {"head": {"tower0": {"offset": {"kernel": np.ones((3, 3, 2, 27), np.float32),
                                             "bias": np.zeros(27, np.float32)}}},
              "prompts": {"d1_share": np.ones((3, 2), np.float32)}}
    _, frozen = jgl._split_params(params)
    out = _reference_honest_offsets(frozen)
    assert all(np.array_equal(np.asarray(out[k]), v) for k, v in frozen.items())
    nested = _reference_honest_offsets(params)
    assert nested["head"]["tower0"]["offset"]["kernel"].max() == 30.0


def test_bench_grounding_runs_on_the_cpu():
    """The bench line's two timings at a tiny config: both finite and > 0."""
    out = bench_grounding(device="cpu", cfg=_tiny(tc), iters=1)
    assert set(out) == {"honest_offsets", "zero_offsets"}
    assert all(np.isfinite(v) and v > 0 for v in out.values()), out


def test_graphs_capture_nothing_on_the_cpu(monkeypatch):
    """`lpi_tpu_torch.graphs` imports without CUDA; `captures` is false on
    the CPU, a capture refuses CPU tensors, and a CPU step and request
    never construct one."""
    assert not graphs.captures("cpu") and graphs.captures("cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        graphs.Graphed(lambda b: b, {"x": torch.zeros(2)}, name="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU call tried to capture")

    monkeypatch.setattr(graphs.Graphed, "__init__", refuse)
    tl = _learner()
    tl.make_step(1, steps_per_epoch=1, epochs=1)(_batches(1)[0])
    predictor = GroundingPredictor(tl.model, tokenizer=BertTokenizer(max_len=16, vocab_size=512),
                                   image_size=64, device="cpu")
    out = predictor.predict(np.zeros((48, 80, 3), np.uint8), "a red car")
    assert out["task_id"] == 0 and not predictor._graphs and not tl._graphs


@pytest.mark.parametrize("zeros", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_giou_product_keeps_the_prod_gradient(zeros, dtype):
    """The GIoU's two-entry product, whose gradient picks its form on the
    device (a captured step cannot read back whether an entry is 0), gives
    `torch.prod`'s value and gradient bit for bit, with and without zero
    entries."""
    rng = np.random.RandomState(int(zeros))
    x = torch.from_numpy(rng.rand(5, 7, 2).astype(np.float32) * 3).to(dtype)
    if zeros:
        x[1, 2, 0] = 0.0
        x[4, 4] = 0.0
    g = torch.from_numpy(rng.randn(5, 7).astype(np.float32)).to(dtype)
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    want, got = torch.prod(a, -1), boxes._Prod2.apply(b)
    assert torch.equal(got, want)
    assert torch.equal(torch.autograd.grad(got, b, g)[0], torch.autograd.grad(want, a, g)[0])
