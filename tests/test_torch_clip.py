"""The CLIP towers and SliNet: the port against the JAX package.

The retrieval gate's tiny CLIP (`bench.py:180-189`: 32 px, patch 8, width
64, 3 layers a tower, 4 heads, embed 32, 4 context tokens; LPI prompts of
length 4, depth 3, rank 2; 3 tasks) is built in JAX in fp32 and its
weights carried into the port by `bridge.slinet_params_from_jax`. Inputs
come from a numpy seed. The bar is the repo's (`_assert_close`: relative
Frobenius 1e-4 and an absolute cap of 3e-3), unless a case says otherwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from lpi_tpu.core import config as jc
from lpi_tpu.models.clip import SliNet as JSliNet
from lpi_tpu.models.clip.model import CLIP as JCLIP
from lpi_tpu.models.clip.model import ResidualAttentionBlock as JBlock
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.bridge import _flatten, _to_state, slinet_params_from_jax
from lpi_tpu_torch.models.clip import SliNet
from lpi_tpu_torch.models.clip.model import ResidualAttentionBlock, prepare_layer_prompts
from tests.test_clip_convert import torch_block
from tests.test_composed_parity import _assert_close, torch_slinet_forward

torch.set_num_threads(1)
TASK = 2
EOT = 49407


def _cfg(c, dtype="float32", depth=1):
    return c.RetrievalConfig(
        clip=c.CLIPConfig(image_resolution=32, patch_size=8, vision_width=64,
                          vision_layers=3, vision_heads=4, text_width=64, text_layers=3,
                          text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
                          n_ctx=4),
        lpi=c.LPIPromptConfig(prompt_length=4, prompt_depth=3, prompt_rank=2,
                              injection_depth=depth),
        total_sessions=3, epochs=4, batch_size=8, lr=0.05, visual_dim=64, textual_dim=64,
        num_key_clusters=2, dtype=dtype)


def _inputs(seed=0, batch=4):
    rng = np.random.RandomState(seed)
    images = rng.randn(batch, 32, 32, 3).astype(np.float32)
    ids = rng.randint(1, 600, size=(batch, 77)).astype(np.int32)
    ids[:, 0] = 49406
    ids[np.arange(batch), 20 + 5 * np.arange(batch)] = EOT  # EOT mid-sequence
    ids[:, 50:] = 0
    ids[0, 3] = 60000  # beyond the vocabulary: the lookup clamps it
    return images, ids


def _pair(dtype="float32", depth=1):
    """(JAX SliNet, its params, the port's SliNet on the same weights)."""
    jm = JSliNet(_cfg(jc, dtype, depth))
    images, ids = _inputs()
    params = unfreeze(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(images),
                                       jnp.asarray(ids), 0)["params"])
    tm = SliNet(_cfg(tc, dtype, depth))
    tm.load_state_dict(slinet_params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair()


# ---- one attention block ------------------------------------------------
@pytest.mark.parametrize("attn_impl", ["bf16", "xla"])
@pytest.mark.parametrize("causal", [False, True])
def test_block_matches_jax_and_the_oracle(attn_impl, causal):
    """One ResidualAttentionBlock (width 64, 4 heads, fp32) against the JAX
    block and against `tests/test_clip_convert.py:torch_block`, an
    independent transcription of OpenAI CLIP's block."""
    rng = np.random.RandomState(1)
    x = rng.randn(3, 11, 64).astype(np.float32)
    jb = JBlock(64, 4, causal, jnp.float32, attn_impl)
    params = jb.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda v: np.asarray(v) + 0.1 * rng.randn(*np.shape(v)), params)
    want = np.asarray(jb.apply({"params": params}, jnp.asarray(x)))
    tb = ResidualAttentionBlock(64, 4, causal, torch.float32, attn_impl)
    tb.load_state_dict(_to_state(_flatten(params)), strict=True)
    with torch.no_grad():
        got = tb(torch.from_numpy(x))
    _assert_close(got.numpy(), want)

    sd = {k: v for k, v in tb.state_dict().items()}
    oracle_sd = {"b.ln_1.weight": sd["ln_1.weight"], "b.ln_1.bias": sd["ln_1.bias"],
                 "b.ln_2.weight": sd["ln_2.weight"], "b.ln_2.bias": sd["ln_2.bias"],
                 "b.attn.in_proj_weight": sd["attn.in_proj.weight"],
                 "b.attn.in_proj_bias": sd["attn.in_proj.bias"],
                 "b.attn.out_proj.weight": sd["attn.out_proj.weight"],
                 "b.attn.out_proj.bias": sd["attn.out_proj.bias"],
                 "b.mlp.c_fc.weight": sd["mlp_c_fc.weight"], "b.mlp.c_fc.bias": sd["mlp_c_fc.bias"],
                 "b.mlp.c_proj.weight": sd["mlp_c_proj.weight"],
                 "b.mlp.c_proj.bias": sd["mlp_c_proj.bias"]}
    oracle = torch_block(torch.from_numpy(x).transpose(0, 1), oracle_sd, "b", 4, causal)
    _assert_close(got.numpy(), oracle.transpose(0, 1).numpy())


def test_prepare_layer_prompts_gates():
    """Layer l >= 1 gets prompt[l] only while l < injection_depth (and the
    stack has it); layer 0 never (its prompt is the caller's)."""
    prompt = torch.arange(3 * 2 * 4, dtype=torch.float32).reshape(3, 2, 4)
    assert prepare_layer_prompts(prompt, 4, 1, torch.float32) == [None] * 4
    two = prepare_layer_prompts(prompt, 4, 2, torch.float32)
    assert two[0] is None and two[2] is None and torch.equal(two[1], prompt[1])
    deep = prepare_layer_prompts(prompt[None].expand(5, -1, -1, -1), 4, 9, torch.bfloat16)
    assert deep[0] is None and deep[3] is None  # the stack has 3 layers
    assert deep[2].shape == (5, 2, 4) and deep[2].dtype == torch.bfloat16


# ---- the towers -----------------------------------------------------------
def _prompts(jm, params, kind):
    """None, one task's stack [L, P, D], or per-sample stacks [B, L, P, D]
    (tasks 2, 0, 1, 2 gathered), as the JAX pool gives them."""
    if kind == "none":
        return None, None
    if kind == "task":
        return jm.apply({"params": params}, TASK, method=jm.task_prompts)
    vis, txt = jm.apply({"params": params}, method=jm.all_task_prompts)
    sel = jnp.asarray([2, 0, 1, 2])
    return jnp.take(vis, sel, axis=0), jnp.take(txt, sel, axis=0)


CASES = [("none", 1), ("task", 1), ("task", 2), ("sample", 1), ("sample", 2)]


@pytest.mark.parametrize("kind,depth", CASES)
def test_encode_image_matches_jax(pair, kind, depth):
    jm, params, tm = pair
    images, _ = _inputs()
    vis, _ = _prompts(jm, params, kind)
    want = JCLIP(jm.cfg.clip, jnp.float32).apply(
        {"params": params["clip"]}, jnp.asarray(images), vis, depth,
        method=JCLIP.encode_image)
    with torch.no_grad():
        got = tm.clip.encode_image(torch.from_numpy(images),
                                   None if vis is None else torch.from_numpy(np.array(vis)),
                                   depth)
    _assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind,depth", CASES)
def test_encode_text_matches_jax(pair, kind, depth):
    """The textual prompt's layer 0 replaces slots 1..P before the positions
    are added; deeper layers are injected when depth allows."""
    jm, params, tm = pair
    _, ids = _inputs()
    _, txt = _prompts(jm, params, kind)
    ctx = None if txt is None else (txt[0] if txt.ndim == 3 else txt[:, 0])
    want = JCLIP(jm.cfg.clip, jnp.float32).apply(
        {"params": params["clip"]}, jnp.asarray(ids), ctx, txt, depth,
        method=JCLIP.encode_text)

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))

    with torch.no_grad():
        got = tm.clip.encode_text(torch.from_numpy(ids).long(), t(ctx), t(txt), depth)
    _assert_close(got.numpy(), np.asarray(want))


def test_train_forward_matches_jax(pair):
    """SliNet's train forward at task 2: both features, both prompt stacks
    and the logit scale."""
    jm, params, tm = pair
    images, ids = _inputs()
    want = jm.apply({"params": params}, jnp.asarray(images), jnp.asarray(ids), TASK)
    with torch.no_grad():
        got = tm(torch.from_numpy(images), torch.from_numpy(ids).long(),
                 torch.tensor(TASK))
    for g, w in zip(got, want):
        _assert_close(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("depth", [1, 2])
def test_train_forward_matches_the_oracle(depth):
    """The port's SliNet forward against
    `tests/test_composed_parity.py:torch_slinet_forward`, an independent
    transcription of the reference SliNet (deep injection at depth 2)."""
    jm, params, tm = _pair(depth=depth)
    images, ids = _inputs()
    ids = np.where(ids < 49408, ids, 1)  # the oracle indexes the table unclamped
    want = torch_slinet_forward(images, ids, params, jm.cfg, TASK)
    with torch.no_grad():
        got = tm(torch.from_numpy(images), torch.from_numpy(ids).long(), TASK)
    for g, w in zip(got, want):
        _assert_close(g.numpy(), w)


def test_per_sample_tasks_match_jax(pair):
    """`encode_image_tasks` / `encode_text_tasks`: the prompts gathered per
    sample by task id."""
    jm, params, tm = pair
    images, ids = _inputs()
    sel = np.asarray([2, 0, 1, 2])
    for jmethod, tfn, x in ((jm.encode_image_tasks, tm.encode_image_tasks,
                             torch.from_numpy(images)),
                            (jm.encode_text_tasks, tm.encode_text_tasks,
                             torch.from_numpy(ids).long())):
        want = jm.apply({"params": params}, jnp.asarray(x.numpy()), jnp.asarray(sel),
                        method=jmethod)
        with torch.no_grad():
            got = tfn(x, torch.from_numpy(sel))
        _assert_close(got.numpy(), np.asarray(want))


def test_frozen_extraction_matches_jax(pair):
    jm, params, tm = pair
    images, ids = _inputs()
    for jmethod, tfn, x in ((jm.extract_visual, tm.extract_visual, torch.from_numpy(images)),
                            (jm.extract_textual, tm.extract_textual,
                             torch.from_numpy(ids).long())):
        want = jm.apply({"params": params}, jnp.asarray(x.numpy()), method=jmethod)
        with torch.no_grad():
            got = tfn(x)
        _assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["maple", "bogus"])
def test_other_prompt_types_are_not_ported(kind):
    """Retrieval has no MaPLe pool and no pool for an unknown type: SliNet
    and `build_prompt_pool` refuse them with the JAX package's ValueError
    (the baselines "sprompts", "l2p" and "clip":
    tests/test_torch_baseline_retrieval.py)."""
    from lpi_tpu.prompts.pools import build_prompt_pool as jbuild
    from lpi_tpu_torch.prompts.pools import build_prompt_pool

    for c, net in ((tc, SliNet), (jc, JSliNet)):
        cfg = _cfg(c)
        bad = dataclasses.replace(cfg, lpi=dataclasses.replace(cfg.lpi, prompt_type=kind))
        with pytest.raises(ValueError, match="prompt_type"):
            if net is SliNet:
                net(bad)
            else:  # Flax builds the pool at init
                images, ids = _inputs()
                net(bad).init(jax.random.PRNGKey(0), jnp.asarray(images), jnp.asarray(ids), 0)
    for build in (build_prompt_pool, jbuild):
        with pytest.raises(ValueError, match="prompt_type"):
            build(kind, 3, 3, 4, 64, 64)
