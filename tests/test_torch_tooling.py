"""The port's tooling against the JAX package on the CPU: LR schedules,
early stopping, exemplars, freeze masks, EMA, the unmasked losses, the
smoothed metric logger and profiling (`lpi_tpu_torch/continual/{schedules,
early_stop,exemplars,freeze,common}.py`, `core/{ema,logging,profiling}.py`,
`losses/clip_loss.py`, `data/retrieval.py`).

The same numpy inputs go through both packages: schedules at relative
1e-6, host objects (plateau, early stop, exemplars, log lines) identical,
the freeze masks on the tiny grounding and retrieval models (seeded
weights of the Flax shapes carried by `bridge`) equal, the losses and
their input gradients at the repo's 1e-4 against JAX and against the
PyTorch oracles of `tests/test_losses.py`.
"""

import inspect
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.core import unfreeze

import lpi_tpu.losses as jloss
from lpi_tpu.continual import common as jcommon
from lpi_tpu.continual import early_stop as jstop
from lpi_tpu.continual import exemplars as jex
from lpi_tpu.continual import freeze as jfreeze
from lpi_tpu.continual import schedules as jsched
from lpi_tpu.core import config as jc
from lpi_tpu.core import ema as jema
from lpi_tpu.core import logging as jlog
from lpi_tpu.core import profiling as jprof
from lpi_tpu.data import retrieval as jretrieval
from lpi_tpu.models.clip.slinet import SliNet as JSliNet
from lpi_tpu.models.glip.grounding import GroundedVLModel as JGroundedVLModel
from lpi_tpu_torch import continual as tcontinual
from lpi_tpu_torch import losses as tlosses
from lpi_tpu_torch.bridge import params_from_jax, slinet_params_from_jax
from lpi_tpu_torch.continual import common as tcommon
from lpi_tpu_torch.continual import early_stop as tstop
from lpi_tpu_torch.continual import exemplars as tex
from lpi_tpu_torch.continual import freeze as tfreeze
from lpi_tpu_torch.continual import schedules as tsched
from lpi_tpu_torch.core import ema as tema
from lpi_tpu_torch.core import logging as tlog
from lpi_tpu_torch.core import profiling as tprof
from lpi_tpu_torch.data import retrieval as tretrieval
from tests.test_composed_parity import _assert_close
from tests.test_losses import torch_clip_loss, torch_nt_bxent
from tests.test_torch_retrieval import _cfg as retrieval_cfg
from tests.test_torch_train import _tiny as grounding_cfg

torch.set_num_threads(1)
N_STEPS = 60


def _rel(got, want, rel=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rel, atol=0)


# ---- schedules ----------------------------------------------------------------
def _jax_traced(schedule, steps):
    """The JAX schedule at int32 steps, as a jitted step calls it. At a
    Python int step it works out the cosine's argument in fp64 (1.7e-6
    from its own traced form near the end of `warmup_cosine`); the port
    works in fp32 for an int and a tensor step alike, as the traced form
    does."""
    return [float(schedule(jnp.int32(s))) for s in steps]


@pytest.mark.parametrize("method", ["linear", "constant"])
def test_warmup_multistep_matches_jax(method):
    kw = dict(gamma=0.3, warmup_factor=0.25, warmup_iters=7, warmup_method=method)
    want = jsched.warmup_multistep(0.02, [10, 10, 25, 40], **kw)
    got = tsched.warmup_multistep(0.02, [10, 10, 25, 40], **kw)
    steps = range(N_STEPS)
    _rel([float(got(s)) for s in steps], [float(want(s)) for s in steps])
    _rel([float(got(torch.tensor(s))) for s in steps], _jax_traced(want, steps))
    assert got(torch.tensor(3)).dtype == torch.float32 and got(3).shape == ()


@pytest.mark.parametrize("method", ["linear", "constant"])
def test_warmup_cosine_matches_jax(method):
    kw = dict(warmup_factor=1 / 3, warmup_iters=9, warmup_method=method, eta_min=1e-4)
    want = jsched.warmup_cosine(0.01, 50, **kw)
    got = tsched.warmup_cosine(0.01, 50, **kw)
    steps = range(N_STEPS)
    _rel([float(got(s)) for s in steps], _jax_traced(want, steps))
    _rel([float(got(torch.tensor(s))) for s in steps], _jax_traced(want, steps))


def test_schedules_refuse_what_jax_refuses():
    with pytest.raises(ValueError, match="increasing"):
        jsched.warmup_multistep(1.0, [20, 10])
    with pytest.raises(ValueError, match="increasing"):
        tsched.warmup_multistep(1.0, [20, 10])
    for mod in (jsched, tsched):
        with pytest.raises(ValueError, match="constant|linear"):
            mod.warmup_cosine(1.0, 10, warmup_method="exp")(0)
        with pytest.raises(ValueError, match="constant|linear"):
            mod.WarmupReduceLROnPlateau(1.0, warmup_method="exp")


@pytest.mark.parametrize("epochs,steps_per_epoch", [(5, 3), (12, 1), (40, 7)])
def test_epoch_cosine_matches_jax_and_equals_the_staged_lrs(epochs, steps_per_epoch):
    want = jcommon.epoch_cosine(0.05, epochs, steps_per_epoch)
    got = tcommon.epoch_cosine(0.05, epochs, steps_per_epoch)
    steps = range(epochs * steps_per_epoch + steps_per_epoch)
    # near the end the lr is a small difference of two fp32 numbers; the
    # absolute floor is a rounding of the base lr
    np.testing.assert_allclose([float(got(s)) for s in steps], [float(want(s)) for s in steps],
                               rtol=1e-6, atol=0.05 * 2 ** -24)
    lrs = tcommon.epoch_lrs(0.05, epochs)
    assert [float(got(s)) for s in steps] == [lrs[s // steps_per_epoch] for s in steps]
    staged = tcommon.staged_lrs(0.05, epochs, "cpu")
    assert all(torch.equal(got(torch.tensor(s)), staged[s // steps_per_epoch]) for s in steps)


# a metric series with plateaus, a 0.0 the plateau logic ignores, and falls
METRICS = [None, None, None, 0.1, 0.2, 0.2, 0.2, 0.0, 0.2, 0.19, 0.3, 0.3, 0.3, 0.3, 0.0,
           0.29, 0.5, 0.5, 0.5, 0.5, 0.5, 0.4, 0.6]


@pytest.mark.parametrize("method,warmup,patience", [("linear", 3, 1), ("constant", 4, 2),
                                                     ("linear", 0, 0)])
def test_plateau_schedule_gives_jax_sequence(method, warmup, patience):
    kw = dict(gamma=0.5, warmup_factor=0.2, warmup_iters=warmup, warmup_method=method,
              eta_min=0.01, patience=patience)
    want, got = jsched.WarmupReduceLROnPlateau(0.1, **kw), tsched.WarmupReduceLROnPlateau(0.1, **kw)
    seq_want = [want.step(m) for m in METRICS]
    seq_got = [got.step(m) for m in METRICS]
    assert seq_got == seq_want
    assert (got.best, got.num_bad, got.last_epoch) == (want.best, want.num_bad, want.last_epoch)
    assert len(set(seq_got)) > 2  # the warmup and at least one cut


@pytest.mark.parametrize("patience,mode", [(2, "max"), (3, "min"), (0, "max")])
def test_early_stopper_gives_jax_sequence(patience, mode):
    series = [m for m in METRICS if m is not None]
    want, got = jstop.EarlyStopper(patience, mode), tstop.EarlyStopper(patience, mode)
    assert [got.update(v) for v in series] == [want.update(v) for v in series]
    assert (got.best, got.bad_count) == (want.best, want.bad_count)


# ---- exemplars ----------------------------------------------------------------
def test_herding_selection_matches_jax():
    rng = np.random.RandomState(3)
    for n, d, m in ((50, 8, 5), (200, 16, 40), (7, 4, 12)):
        feats = rng.randn(n, d)
        np.testing.assert_array_equal(tex.herding_selection(feats, m),
                                      jex.herding_selection(feats, m))


def test_exemplar_memory_and_nme_match_jax():
    rng = np.random.RandomState(4)
    classes = {c: rng.randn(30 + 5 * c, 12) + 3 * rng.randn(12) for c in range(4)}
    want, got = jex.ExemplarMemory(memory_size=24), tex.ExemplarMemory(memory_size=24)
    query = rng.randn(40, 12) * 2
    for c, feats in classes.items():
        want.update(c, feats, payload=f"class {c}")
        got.update(c, feats, payload=f"class {c}")
        assert got.per_class == want.per_class
        for k in classes:
            np.testing.assert_array_equal(got.exemplars(k), want.exemplars(k))
        np.testing.assert_array_equal(got.nme_classify(query), want.nme_classify(query))
    means_got, means_want = got.class_means(), want.class_means()
    assert sorted(means_got) == sorted(means_want)
    for c in means_want:
        np.testing.assert_array_equal(means_got[c], means_want[c])
    empty = tex.ExemplarMemory(memory_size=0)
    empty.update(0, classes[0])
    assert empty.store == {} and list(empty.nme_classify(query)) == [0] * 40


# ---- freeze masks -------------------------------------------------------------
def _seeded(shapes, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda s: np.asarray(rng.randn(*s.shape), np.float32), unfreeze(shapes))


@pytest.fixture(scope="module")
def tiny_models():
    """{kind: (Flax params of the tiny model's shapes, seeded; the same
    tree bridged to the port's names, a bridging function)}."""
    gcfg = grounding_cfg(jc)
    g_shapes = jax.eval_shape(
        JGroundedVLModel(gcfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 16), jnp.int32), jnp.ones((1, 16), jnp.int32),
        0)["params"]
    rcfg = retrieval_cfg(jc)
    r_shapes = jax.eval_shape(JSliNet(rcfg).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 77), jnp.int32),
                              0)["params"]
    bridges = {"grounding": lambda t: params_from_jax(t, depths=gcfg.swin.depths),
               "retrieval": slinet_params_from_jax}
    out = {}
    for kind, shapes, seed in (("grounding", g_shapes, 0), ("retrieval", r_shapes, 1)):
        jparams = _seeded(shapes, seed)
        out[kind] = (jparams, bridges[kind](jparams), bridges[kind])
    return out


@pytest.mark.parametrize("kind", ["grounding", "retrieval"])
@pytest.mark.parametrize("task", [0, 2])
def test_count_trainable_and_mask_match_jax(tiny_models, kind, task):
    jparams, tparams, _ = tiny_models[kind]
    n = tfreeze.count_trainable(tparams, task)
    assert n == jfreeze.count_trainable(jparams, task) > 0
    mask = tfreeze.trainable_mask(tparams)
    assert sum(mask.values()) == (15 if kind == "grounding" else 6)
    assert n == sum(tparams[k][task].numel() for k, pool in mask.items() if pool)
    assert all(v.shape[0] == 3 for k, v in tparams.items() if mask[k])


@pytest.mark.parametrize("kind", ["grounding", "retrieval"])
def test_mask_grads_match_jax_leaf_by_leaf(tiny_models, kind):
    jparams, tparams, bridge = tiny_models[kind]
    jgrads = _seeded(jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jparams), 7)
    want = bridge(jax.tree.map(np.asarray, jax.jit(jfreeze.mask_grads)(jgrads, 1)))
    tgrads = bridge(jgrads)
    for task in (1, torch.tensor(1)):
        got = tfreeze.mask_grads(tgrads, task)
        assert set(got) == set(want) == set(tparams)
        for name, g in got.items():
            assert torch.equal(g, want[name]), name
    pools = [n for n, pool in tfreeze.trainable_mask(tparams).items() if pool]
    assert pools and all(torch.equal(got[n][1], tgrads[n][1]) and not got[n][0].any()
                         for n in pools)


# ---- EMA ----------------------------------------------------------------------
def test_update_ema_matches_jax():
    rng = np.random.RandomState(5)
    shapes = {"a.weight": (6, 5), "b.bias": (5,), "c": ()}
    p0 = {k: np.asarray(rng.randn(*s), np.float32) for k, s in shapes.items()}
    steps = [{k: np.asarray(rng.randn(*s), np.float32) for k, s in shapes.items()}
             for _ in range(4)]
    jstate = jema.init_ema({k: jnp.asarray(v) for k, v in p0.items()})
    params = {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in p0.items()}
    tstate = tema.init_ema(params)
    assert all(not v.requires_grad and v.data_ptr() != params[k].data_ptr()
               for k, v in tstate.items())
    for decay, p in zip((0.9, 0.9999, 0.5, 0.0), steps):
        jstate = jema.update_ema(jstate, {k: jnp.asarray(v) for k, v in p.items()}, decay)
        tstate = tema.update_ema(tstate, {k: torch.from_numpy(v) for k, v in p.items()}, decay)
        for k in shapes:
            _rel(tstate[k].numpy(), np.asarray(jstate[k]))
    np.testing.assert_array_equal(tstate["c"].numpy(), steps[-1]["c"])  # decay 0: the params
    out = tema.update_ema({"w": torch.ones(3)}, {"w": torch.zeros(3)}, decay=0.9)
    np.testing.assert_allclose(out["w"].numpy(), 0.9)  # tests/test_aux.py's case


# ---- the unmasked losses ------------------------------------------------------
def _value_and_grads(tfn, jfn, arrays, **kw):
    """(port's value, its gradients with respect to every array; JAX's)."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    tv = tfn(*ts, **kw)
    tg = torch.autograd.grad(tv, ts)
    jv, jg = jax.jit(jax.value_and_grad(lambda *xs: jfn(*xs, **kw),
                                        argnums=tuple(range(len(arrays)))))(
        *[jnp.asarray(a) for a in arrays])
    return (tv.item(), [g.numpy() for g in tg]), (float(jv), [np.asarray(g) for g in jg])


def _relation(rng, n):
    """A task relation of two or three groups: every row has a positive (its
    diagonal at least) and a negative, as the reference's relations do (a
    row without negatives divides 0 by 0 in both packages)."""
    groups = rng.randint(0, 3, size=n)
    groups[:2] = (0, 1)
    return (groups[:, None] == groups[None, :]).astype(np.float32)


@pytest.mark.parametrize("n,d,temperature", [(6, 24, 0.5), (4, 1536, 0.001), (9, 7, 1.0)])
def test_nt_bxent_loss_matches_jax_and_the_torch_oracle(n, d, temperature):
    rng = np.random.RandomState(n)
    x, rel = rng.randn(n, d).astype(np.float32), _relation(rng, n)
    (tv, (tg,)), (jv, (jg,)) = _value_and_grads(
        lambda a: tlosses.nt_bxent_loss(a, torch.from_numpy(rel), temperature),
        lambda a: jloss.nt_bxent_loss(a, jnp.asarray(rel), temperature), [x])
    _assert_close(tv, jv)
    _assert_close(tv, torch_nt_bxent(x, rel, temperature))
    _assert_close(tg, jg)


def test_task_prompt_loss_matches_jax():
    rng = np.random.RandomState(11)
    vis, txt, rel = (rng.randn(5, 96).astype(np.float32), rng.randn(5, 80).astype(np.float32),
                     _relation(rng, 5))
    (tv, tg), (jv, jg) = _value_and_grads(
        lambda v, t: tlosses.task_prompt_loss(v, t, torch.from_numpy(rel)),
        lambda v, t: jloss.task_prompt_loss(v, t, jnp.asarray(rel)), [vis, txt])
    _assert_close(tv, jv)
    _assert_close(tv, 0.5 * (torch_nt_bxent(vis, rel, 0.001) + torch_nt_bxent(txt, rel, 0.001)))
    for a, b in zip(tg, jg):
        _assert_close(a, b)
    # every row valid: the masked form at the last task is the unmasked loss
    masked = tlosses.task_prompt_loss_masked(torch.from_numpy(vis), torch.from_numpy(txt),
                                             torch.from_numpy(rel), 4)
    _assert_close(masked.item(), tv)


@pytest.mark.parametrize("temperature", [0.1, 0.07])
def test_info_nce_matches_jax_and_cross_entropy(temperature):
    rng = np.random.RandomState(12)
    q, k = rng.randn(8, 16).astype(np.float32), rng.randn(8, 16).astype(np.float32)
    (tv, tg), (jv, jg) = _value_and_grads(tlosses.info_nce, jloss.info_nce, [q, k],
                                          temperature=temperature)
    _assert_close(tv, jv)
    qn, kn = F.normalize(torch.from_numpy(q), dim=-1), F.normalize(torch.from_numpy(k), dim=-1)
    _assert_close(tv, F.cross_entropy(qn @ kn.T / temperature, torch.arange(8)).item())
    for a, b in zip(tg, jg):
        _assert_close(a, b)
    logits = rng.randn(8, 8).astype(np.float32) * 3
    _assert_close(tlosses.clip_loss(torch.from_numpy(logits)).item(), torch_clip_loss(logits))


def test_the_package_exports_match_jax():
    import lpi_tpu.continual as jcont
    import lpi_tpu.losses as jl

    for jmod, tmod in ((jl, tlosses), (jcont, tcontinual)):
        names = {n for n, v in vars(jmod).items()
                 if not n.startswith("_") and not inspect.ismodule(v)}
        assert names and names <= set(vars(tmod)), sorted(names - set(vars(tmod)))
    assert tretrieval.DEFAULT_TASK_ORDER == jretrieval.DEFAULT_TASK_ORDER


# ---- the metric logger --------------------------------------------------------
def test_smoothed_value_matches_jax():
    rng = np.random.RandomState(13)
    want, got = jlog.SmoothedValue(), tlog.SmoothedValue()
    for v in rng.randn(45):
        want.update(v)
        got.update(v)
        assert (got.median, got.avg, got.global_avg, got.count) == (
            want.median, want.avg, want.global_avg, want.count)
    assert len(got.deque) == 20
    short_w, short_g = jlog.SmoothedValue(window_size=3), tlog.SmoothedValue(window_size=3)
    for v in (4.0, 1.0, 3.0, 2.0):
        short_w.update(v)
        short_g.update(v)
    assert (short_g.median, short_g.avg, short_g.global_avg) == (
        short_w.median, short_w.avg, short_w.global_avg) == (2.0, 2.0, 2.5)


def test_log_line_matches_jax(monkeypatch, tmp_path):
    now = [100.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    want = jlog.MetricLogger()
    got = tlog.MetricLogger(jsonl_path=str(tmp_path / "m.jsonl"))
    for step in range(2):
        now[0] = 101.0 + step
        losses = {"total": 1.5 / (step + 1), "task_loss": 0.25 * step}
        want.update(**losses)
        got.update(**losses)
    now[0] = 130.5
    lines = [logger.log_line(2, 12, prefix="task 1 ") for logger in (want, got)]
    assert lines[1] == lines[0] == "task 1 [2/12]  eta 152s  total 1.1250  task_loss 0.1250"
    assert tlog.MetricLogger(delimiter=" | ").delimiter == " | "
    got.close()
    recs = [json.loads(r) for r in open(tmp_path / "m.jsonl")]
    assert [r["time"] for r in recs] == [101.0, 102.0] and recs[1]["total"] == 0.75


# ---- profiling ----------------------------------------------------------------
def test_compiled_flops_of_a_matmul_matches_jax():
    a = np.ones((64, 64), np.float32)
    got = tprof.compiled_flops(lambda x: x @ x, torch.from_numpy(a))
    want = jprof.compiled_flops(lambda x: x @ x, jnp.asarray(a))
    assert got["flops"] == 2 * 64 ** 3 == want["flops"]
    assert set(got) == set(want) and got["bytes_accessed"] is None is got["transcendentals"]


def test_device_memory_stats_and_trace_on_the_cpu(tmp_path):
    assert tprof.device_memory_stats("cpu") == {}
    a = torch.randn(32, 32)
    with tprof.trace(str(tmp_path)):
        (a @ a).sum()
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    events = json.load(open(tmp_path / files[0]))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_step_timer():
    """tests/test_aux.py's case, and the statistics over several steps."""
    t = tprof.StepTimer()
    assert t.mean == t.p50 == 0.0
    t.start()
    dt = t.stop(torch.ones(8, 8) * 2)
    assert dt > 0 and t.mean > 0 and t.p50 > 0
    t.times = [0.3, 0.1, 0.2, 0.5]
    assert t.p50 == pytest.approx(0.25) and t.mean == pytest.approx(0.275)
    t.start()
    t.stop({"loss": [torch.zeros(())]})
    assert len(t.times) == 5
