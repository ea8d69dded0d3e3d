"""The grounding model with early fusion (GLIP-T(C)'s deep fusion): the port
against the JAX package.

One tiny LPI learner (`tests/test_grounding.py`'s TINY widths, one
deformable tower at 16 channels, 32 px) with `dyhead.early_fuse=True`:
before the tower a VLFuse over the five FPN levels and the language hidden
states, then a BERT layer on the hidden states. It is built once in JAX
and its weights carried into the port by `bridge.params_from_jax`, which
must map every leaf (`head/fuse0/b_attn/**`, `head/lang0/**` among them).
The JAX side's `value_and_grad(_losses)` at task 1 is compiled once, with
the train forward's outputs taken from inside it; `forward_tasks` is held
to that train forward. Outputs, losses and the pool gradients (each leaf
too) are held to the repo's bar, relative Frobenius 1e-4 plus an absolute
cap of 3e-3. The tower's deformable convs take the "exact" route: JAX
compiles this program's gradient on the CPU in about 75 s with it and
about 120 s with "pallas" (the window route is held in the whole model by
`tests/test_torch_grounding.py`, and with early fusion card against CPU
by `chip_smoke.py` phase 14). `forward_knowledge` is held in
`tests/test_torch_knowledge.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from lpi_tpu.continual import grounding_learner as jgl
from lpi_tpu.core import config as jc
from lpi_tpu.data.bert_tokenizer import BertTokenizer as JTokenizer
from lpi_tpu.data.grounding import synthetic_grounding_task as j_synthetic
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.bridge import params_from_jax
from lpi_tpu_torch.continual import grounding_learner as tgl
from lpi_tpu_torch.models.glip.vlfuse import VLFuse
from tests.test_composed_parity import _assert_close

torch.set_num_threads(1)
TASK = 1
SIZE = 32
DEPTHS = (2, 2, 2, 2)


def tiny(c, **dyhead):
    """TINY widths, one "exact" tower, early fusion at embed 32 over 4
    heads; `dyhead` overrides the head's fields."""
    return c.GroundingConfig(
        swin=c.SwinConfig(patch_size=4, embed_dim=8, depths=DEPTHS,
                          num_heads=(1, 2, 2, 2), window_size=4),
        bert=c.BertConfig(vocab_size=512, hidden_size=16, num_layers=8, num_heads=2,
                          intermediate_size=32, max_position_embeddings=32,
                          max_query_len=16),
        fused_scan_unroll=99,
        dyhead=c.DyHeadConfig(num_convs=1, channels=16, max_tokens=16, early_fuse=True,
                              fuse_embed_dim=32, fuse_heads=4,
                              **{"deform_impl": "exact", **dyhead}),
        atss=c.ATSSConfig(anchor_sizes=(8, 16, 32, 64, 128),
                          anchor_strides=(4, 8, 16, 32, 64), pre_nms_top_n=50,
                          fpn_post_nms_top_n=10),
        lpi=c.LPIPromptConfig(prompt_length=4, prompt_depth=6, prompt_rank=2,
                              interact_rank=2, interact_depth=6),
        total_tasks=3, epochs_per_task=1, batch_size=2, max_boxes=4,
        image_size=SIZE, num_key_clusters=2, dtype="float32")


def carried(params) -> dict:
    """The JAX params tree as the port's state_dict."""
    return params_from_jax(jax.tree.map(np.asarray, params), depths=DEPTHS)


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
            flat, language, _, _ = out
            self.seen.append(({k: flat[k] for k in ("bbox_pred", "centerness", "dot_logits",
                                                    "anchors")},
                              {k: language[k] for k in ("embedded", "hidden")}))
        return out


@pytest.fixture(scope="module")
def pair():
    """The JAX learner and the port's on the same weights; JAX's losses and
    pool gradients at task 1 and the train forward they came from."""
    batch = _batch()
    jl = jgl.GroundingLearner(tiny(jc), task_sim_matrix=np.eye(3), sample_batch=batch)
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
    state = carried(jl.params)
    tl = tgl.GroundingLearner(tiny(tc), task_sim_matrix=np.eye(3), init_params=state,
                              device="cpu")
    tree = traverse_util.unflatten_dict({k: np.asarray(v) for k, v in grads.items()})
    return dict(jl=jl, tl=tl, state=state, batch=batch, flat=forward[0],
                language=forward[1], total=total, metrics=metrics,
                grads=params_from_jax(tree, depths=DEPTHS))


def test_every_leaf_is_carried_both_ways(pair):
    """`params_from_jax` maps every JAX leaf to a port parameter and the
    port has no parameter it does not fill: the VLFuse leaves, the head's
    BERT layer, the tower's convs."""
    tl, state = pair["tl"], pair["state"]
    own = dict(tl.model.named_parameters())
    assert set(state) == set(own)
    assert any(k.startswith("head.fuses.0.b_attn.attn.v_proj.") for k in state)
    assert any(k.startswith("head.langs.0.attention.query.") for k in state)
    assert "head.fuses.0.b_attn.gamma_v" in state
    assert isinstance(tl.model.head.fuses[0], VLFuse)
    for k, v in state.items():
        assert torch.equal(own[k].detach(), v), k


def test_train_forward_matches_jax(pair):
    """The train forward at task 1: head outputs and the language features
    (the head's dot product reads `embedded`; the fusion reads `hidden`)."""
    tl = pair["tl"]
    b = tl.to_device(pair["batch"])
    with torch.no_grad():
        flat, language, _, _ = tl.model(b["images"], b["input_ids"], b["attention_mask"], TASK)
    for key in ("bbox_pred", "centerness", "dot_logits", "anchors"):
        _assert_close(flat[key].numpy(), np.asarray(pair["flat"][key]))
    for key in ("embedded", "hidden"):
        _assert_close(language[key].numpy(), np.asarray(pair["language"][key]))


def test_forward_tasks_matches_jax(pair):
    """Per-sample tasks [1, 1] (each sample's prompts gathered, the
    interaction following the first) against JAX's train forward at task
    1; tasks [2, 1] move both samples (the interaction follows task 2)."""
    tl = pair["tl"]
    b = tl.to_device(pair["batch"])
    with torch.no_grad():
        flat, language = tl.model.forward_tasks(b["images"], b["input_ids"],
                                                b["attention_mask"], torch.tensor([1, 1]))
        other, _ = tl.model.forward_tasks(b["images"], b["input_ids"], b["attention_mask"],
                                          torch.tensor([2, 1]))
    for key in ("bbox_pred", "centerness", "dot_logits"):
        _assert_close(flat[key].numpy(), np.asarray(pair["flat"][key]))
    _assert_close(language["hidden"].numpy(), np.asarray(pair["language"]["hidden"]))
    for i in (0, 1):
        assert not torch.equal(other["dot_logits"][i], flat["dot_logits"][i])


def test_losses_and_pool_gradients_match_jax(pair):
    """Each loss term, the total, and the gradient of every pool leaf
    (each and concatenated): the pools' gradient flows back through the
    frozen VLFuse and BERT layer into the language stream."""
    tl = pair["tl"]
    total, metrics = tl._losses(tl.to_device(pair["batch"]), TASK)
    want = pair["metrics"]
    assert set(metrics) == set(want)
    assert metrics["num_pos"].item() == float(want["num_pos"]) > 0
    for key in set(want) - {"num_pos"}:
        _assert_close(np.float64(metrics[key].item()), np.float64(want[key]))
    _assert_close(np.float64(total.item()), np.float64(pair["total"]))
    names = sorted(tl.pools)
    assert names == sorted(pair["grads"])
    grads = torch.autograd.grad(total, [tl.pools[n] for n in names])
    _assert_close(np.concatenate([g.numpy().ravel() for g in grads]),
                  np.concatenate([pair["grads"][n].numpy().ravel() for n in names]))
    for n, g in zip(names, grads):
        _assert_close(g.numpy(), pair["grads"][n].numpy())
        assert g[TASK].abs().sum() > 0, n
    assert not any(p.requires_grad for n, p in tl.model.named_parameters()
                   if n.startswith(("head.fuses.", "head.langs.")))
