"""The tiny grounding model in bf16: the port against the JAX package.

`tests/test_torch_train.py`'s tiny config with `dtype="bfloat16"` in both
packages (parameters fp32, compute bf16, LayerNorms, softmaxes and the
deformable sums in fp32, the product maps in bf16), the JAX learner's
weights carried by `bridge.params_from_jax`, the offset convs scaled by 8
(offsets of a few tenths of a pixel, inside the map at every level). The
two packages round in different places (XLA on the CPU and the Pallas
kernels in interpret mode against PyTorch's CPU kernels), so the errors
are relative Frobenius, printed in bf16 steps (2^-8), and each head bar is
a multiple of the JAX package's own bf16-against-fp32 error on the same
weights and inputs, a quantity the port cannot move:

* the whole model, head outputs (`dot_logits`, `bbox_pred`, `centerness`),
  whole and at the 8x8 and 4x4 levels: twice the JAX package's own error.
  The backbone's roundings diverge between the packages, so at the head
  the two bf16 errors are about independent: their difference is about
  sqrt(2) times one of them, and the port's own error is not the JAX
  package's (measured: 0.64-1.14 of it), hence a further sqrt(2).
  Measured: 0.69-1.64 of the JAX package's own error (`bbox_pred` and
  `centerness`, small sums of about 0.02, 7.1-9.0 steps; `dot_logits`
  0.3-0.4). This catches a fault as large as the bf16 error itself; the
  head's own roundings are too few to move it (a dropped, added or moved
  rounding in the head moved these errors by at most 0.1 step).
* the task-1 pool gradient of the learner's loss: 16 steps, set from the
  roundings' count before the first measurement (about 50 roundings to
  bf16 in the forward, each within half a step, about sqrt(50) / 2 < 4
  steps; the backward repeats them and rounds its own products; the focal
  and GIoU terms weight the head's errors unevenly). Measured: 0.15.
* the head alone (`VLDyHead`: the tower and the three outputs), both
  packages fed the JAX model's own bf16 FPN features and text embedding:
  half the JAX head's own bf16-against-fp32 error. Two heads that round at
  the same points on the same inputs share most of their rounding error;
  one that drops, adds or moves a rounding differs by about as much as one
  head differs from fp32. Measured: 0.13-0.44 of the JAX head's own error
  (0.5-0.9 steps on `bbox_pred` and `centerness`); planted faults in a
  copy of the port, each above this bar: the deform conv's
  output kept in fp32 (its bf16 cast dropped) 0.65-0.84, the product maps
  in fp32 0.96-1.16, the features rounded to bf16 once more before the
  output convs 0.61-0.82.

The 1x1 and 2x2 levels are compared only within the whole outputs: there a
relative bar measures rounding noise of a few values.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.continual import grounding_learner as jgl
from lpi_tpu.core import config as jc
from lpi_tpu.data.bert_tokenizer import BertTokenizer as JTokenizer
from lpi_tpu.data.grounding import synthetic_grounding_task as j_synthetic
from lpi_tpu.models.glip.grounding import GroundedVLModel as JModel
from lpi_tpu.models.glip.vldyhead import VLDyHead as JHead
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.bridge import params_from_jax
from lpi_tpu_torch.continual import grounding_learner as tgl
from tests.test_torch_train import TASK, ForwardSpy, _tiny, _torch_names

torch.set_num_threads(1)
STEP = 2.0 ** -8
GRADIENT_BAR = 16 * STEP
MODEL_FACTOR = 2.0  # x the JAX model's own bf16-against-fp32 error
HEAD_FACTOR = 0.5  # x the JAX head's own bf16-against-fp32 error
HEADS = ("dot_logits", "bbox_pred", "centerness")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _bf16(c):
    return dataclasses.replace(_tiny(c), dtype="bfloat16")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _levels(flat, counts, key):
    """{name: [B, A, ...] array}: the whole output and its 8x8 and 4x4 levels
    (the first two at 64 px)."""
    starts = np.concatenate([[0], np.cumsum(counts)])
    out = {key: flat}
    for level in (0, 1):
        side = int(np.sqrt(counts[level]))
        out[f"{key}@{side}x{side}"] = flat[:, starts[level]:starts[level + 1]]
    return out


def _bars(outputs, factor):
    """outputs: (port bf16, JAX bf16, JAX fp32) {name: array} -> ({name:
    port against JAX}, {name: `factor` x JAX bf16 against JAX fp32})."""
    ours, theirs, theirs32 = outputs
    return ({n: _rel(ours[n], theirs[n]) for n in ours},
            {n: factor * _rel(theirs[n], theirs32[n]) for n in ours})


def _report(what, errors, bars):
    print(f"{what}: bf16 relative Frobenius errors in bf16 steps (bar): "
          + ", ".join(f"{k} {errors[k] / STEP:.2f} ({bars[k] / STEP:.2f})" for k in errors))


class _FpnSpy(ForwardSpy):
    """A `ForwardSpy` that also captures the FPN's output of each train
    forward: it keeps (outputs, intermediates) and returns the outputs."""

    def apply(self, *args, **kw):
        if kw.get("method") is not None:
            return self.model.apply(*args, **kw)
        out, inter = self.model.apply(
            *args, capture_intermediates=lambda m, method: m.name == "fpn"
            and method == "__call__", **kw)
        self.seen.append((out, inter))
        return out


@pytest.fixture(scope="module")
def carried():
    """Both packages' tiny bf16 learners on one set of weights, the JAX
    model's bf16 and fp32 forwards, its pool gradient and its bf16 FPN
    features and text embedding (the head's inputs)."""
    jtok = JTokenizer(max_len=16, vocab_size=512)
    batch = next(j_synthetic(TASK, num_samples=4, image_size=64, tokenizer=jtok).batches(2))
    jl = jgl.GroundingLearner(_bf16(jc), task_sim_matrix=np.eye(3), sample_batch=batch)
    jl.params = jax.tree_util.tree_map_with_path(
        lambda p, v: v * 8.0 if "offset" in jax.tree_util.keystr(p) else v, jl.params)
    pools, frozen = jgl._split_params(jl.params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j32 = JModel(_tiny(jc))

    spy = _FpnSpy(jl.model)

    def total(p, b):
        return jl._losses(p, frozen, b, TASK)[0], spy.seen[-1]

    @jax.jit
    def forwards_and_grads(pools, frozen, b):
        """The bf16 forward is the one inside `_losses` (one trace of it)."""
        model, jl.model = jl.model, spy
        try:
            grads, ((flat, language, _, _), inter) = jax.grad(total, has_aux=True)(pools, b)
        finally:
            jl.model = model
        args = (b["images"], b["input_ids"], b["attention_mask"], TASK)
        return (flat, j32.apply({"params": jgl._merge(pools, frozen)}, *args)[0], grads,
                inter["intermediates"]["fpn"]["__call__"][0], language["embedded"])

    jflat, jflat32, jgrads, feats, embedded = forwards_and_grads(pools, frozen, jb)
    state = params_from_jax(jax.tree.map(np.asarray, jl.params), depths=(2, 2, 2, 2))
    tl = tgl.GroundingLearner(_bf16(tc), task_sim_matrix=np.eye(3), init_params=state,
                              device="cpu")
    return SimpleNamespace(jl=jl, batch=batch, jflat=jflat, jflat32=jflat32, jgrads=jgrads,
                           feats=feats, embedded=embedded, tl=tl)


def test_bf16_head_outputs_and_pool_gradient_agree_with_jax(carried):
    """Head outputs at task 1 and the task-1 rows of the pool gradient of
    `_losses`, the port against the JAX package, both in bf16 from carried
    weights: each head output within `MODEL_FACTOR` times the JAX model's
    own bf16-against-fp32 error, the gradient within `GRADIENT_BAR`,
    relative Frobenius."""
    tl = carried.tl
    b = tl.to_device(carried.batch)
    with torch.no_grad():
        flat = tl.model(b["images"], b["input_ids"], b["attention_mask"], TASK)[0]
    counts = flat["level_counts"]
    errors, bars = {}, {}
    for key in HEADS:
        e, m = _bars([_levels(_np(f[key]), counts, key)
                      for f in (flat, carried.jflat, carried.jflat32)], MODEL_FACTOR)
        errors.update(e)
        bars.update(m)

    total, _ = tl._losses(b, TASK)
    names = sorted(tl.pools)
    grads = torch.autograd.grad(total, [tl.pools[n] for n in names])
    want = _torch_names(carried.jgrads)
    grad = _rel(np.concatenate([g[TASK].float().numpy().ravel() for g in grads]),
                np.concatenate([want[n][TASK].float().numpy().ravel() for n in names]))
    _report("whole model", errors, bars)
    print(f"pool gradient {grad / STEP:.2f} ({GRADIENT_BAR / STEP:.0f})")
    assert all(errors[k] <= bars[k] for k in errors), (errors, bars)
    assert grad <= GRADIENT_BAR, (grad, GRADIENT_BAR)


def test_bf16_head_alone_agrees_with_jax_on_shared_inputs(carried):
    """The head (`VLDyHead`) alone in bf16, both packages fed the JAX
    model's bf16 FPN features and text embedding: each output, whole and at
    the 8x8 and 4x4 levels, within `HEAD_FACTOR` times the JAX head's own
    bf16-against-fp32 error (its fp32 twin fed the same values in fp32),
    relative Frobenius."""
    c = _tiny(jc)
    mask = carried.batch["attention_mask"]
    head_params = {"params": carried.jl.params["head"]}
    feats, embedded = carried.feats, carried.embedded

    def jax_head(dtype, cast):
        head = JHead(c.dyhead, lang_dim=c.bert.hidden_size, num_anchors=1, dtype=dtype)
        return head.apply(head_params, [cast(f) for f in feats], cast(embedded),
                          jnp.asarray(mask))

    j16 = jax_head(jnp.bfloat16, lambda x: x)
    j32 = jax_head(jnp.float32, lambda x: x.astype(jnp.float32))
    tfeats = [torch.from_numpy(_np(f)).to(torch.bfloat16) for f in feats]
    with torch.no_grad():
        t16 = carried.tl.model.head(tfeats, torch.from_numpy(_np(embedded)).to(torch.bfloat16),
                                    torch.from_numpy(np.asarray(mask)))
    counts = [f.shape[1] * f.shape[2] for f in feats]
    errors, bars = {}, {}
    for key in HEADS:
        e, m = _bars([_levels(np.concatenate([_np(p).reshape(p.shape[0], n, -1)
                                              for p, n in zip(out[key], counts)], 1),
                              counts, key) for out in (t16, j16, j32)], HEAD_FACTOR)
        errors.update(e)
        bars.update(m)
    _report("head alone", errors, bars)
    assert all(errors[k] <= bars[k] for k in errors), (errors, bars)
