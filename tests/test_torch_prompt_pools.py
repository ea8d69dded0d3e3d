"""The baseline prompt pools: the port against the JAX package.

`NormalPromptPool` (S-Prompts), `MaPLePromptPool` and `L2pPrompt` are built
in Flax, their parameters carried into the port's modules by the bridge's
leaf mapping (`proj_kernel` copied as it is: its name is not `kernel`), and
each method is held to the JAX one on numpy inputs from a seed: the
repo's bar (relative Frobenius 1e-4 and an absolute cap of 3e-3) on
values and gradients, exact equality on L2P's chosen indices, in fp32 and
bf16, ties among the counts included. The initialisers are held to the
JAX package's distributions by their moments and bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.prompts import pools as jp
from lpi_tpu_torch.bridge import _flatten, _to_state
from lpi_tpu_torch.prompts import pools as tp
from tests.test_composed_parity import _assert_close

torch.set_num_threads(1)
T, L, P, DV, DT = 3, 4, 5, 8, 12


def _carry(jmodule, tmodule, *init_args):
    """Flax-init `jmodule`, copy its parameters into `tmodule`. -> params."""
    params = jmodule.init(jax.random.PRNGKey(0), *init_args)["params"]
    tmodule.load_state_dict(_to_state(_flatten(jax.tree.map(np.asarray, params))), strict=True)
    return params


def _dense_pools(kind):
    if kind == "sprompts":
        return (jp.NormalPromptPool(num_tasks=T, layer_num=L, prompt_num=P, visual_dim=DV,
                                    textual_dim=DT),
                tp.NormalPromptPool(T, L, P, DV, DT))
    return (jp.MaPLePromptPool(num_tasks=T, layer_num=L, prompt_num=P, visual_dim=DV,
                               textual_dim=DT),
            tp.MaPLePromptPool(T, L, P, DV, DT))


@pytest.mark.parametrize("kind", ["sprompts", "maple"])
def test_dense_pool_methods_match_jax(kind):
    """`forward` (an int and a 0-d tensor task id), `all_prompts` and
    `gather`, and the gradient of a weighted sum of `gather`'s output with
    respect to every leaf."""
    jm, tm = _dense_pools(kind)
    params = _carry(jm, tm, 1)
    ids = np.array([2, 0, 2, 1])
    for task in (0, 2):
        want = jm.apply({"params": params}, task)
        for tid in (task, torch.tensor(task)):
            with torch.no_grad():
                got = tm(tid)
            for g, w in zip(got, want):
                _assert_close(g.detach().numpy(), np.asarray(w))
    for g, w in zip(tm.all_prompts(), jm.apply({"params": params}, method=jm.all_prompts)):
        _assert_close(g.detach().numpy(), np.asarray(w))

    rng = np.random.RandomState(1)
    wv = rng.randn(len(ids), L, P, DV).astype(np.float32)
    wt = rng.randn(len(ids), L, P, DT).astype(np.float32)

    def jloss(p):
        v, t = jm.apply({"params": p}, jnp.asarray(ids), method=jm.gather)
        return jnp.sum(v * wv) + jnp.sum(t * wt), (v, t)

    (_, (jv, jt)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    v, t = tm.gather(torch.from_numpy(ids))
    _assert_close(v.detach().numpy(), np.asarray(jv))
    _assert_close(t.detach().numpy(), np.asarray(jt))
    loss = (v * torch.from_numpy(wv)).sum() + (t * torch.from_numpy(wt)).sum()
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, list(tm.parameters()))
    want = _to_state(_flatten(jax.tree.map(np.asarray, jgrads)))
    assert sorted(names) == sorted(want)
    for n, g in zip(names, grads):
        _assert_close(g.numpy(), want[n].numpy())
    if kind == "maple":
        # a [T, L, Dt, Dv] leaf not named `kernel` keeps its layout
        assert tm.proj_kernel.shape == (T, L, DT, DV)
        np.testing.assert_array_equal(tm.proj_kernel.detach().numpy(),
                                      np.asarray(params["proj_kernel"]))


def _l2p(pool=6, top_k=3, length=2, dim=16):
    """The pool as SliNet builds it in both packages: the batchwise vote
    over the keys of the mean token."""
    jm = jp.L2pPrompt(pool_size=pool, length=length, embed_dim=dim, top_k=top_k)
    tm = tp.L2pPrompt(pool_size=pool, length=length, embed_dim=dim, top_k=top_k)
    return jm, tm


def _l2p_check(jm, tm, params, x, dtype):
    """Every output of the L2P forward against JAX's on `x` in `dtype`, and
    the gradient of a weighted sum of the prompted embedding with respect
    to the pool. -> the chosen indices."""
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    w = np.random.RandomState(2).randn(*x.shape).astype(np.float32)

    def jloss(p):
        out = jm.apply({"params": p}, jx)
        return jnp.sum(out["prompted_embedding"].astype(jnp.float32) * w), out

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    got = tm(torch.from_numpy(x).to(dtype))
    np.testing.assert_array_equal(got["prompt_idx"].numpy(), np.asarray(want["prompt_idx"]))
    assert got["total_prompt_len"] == want["total_prompt_len"]
    assert got["prompted_embedding"].dtype == dtype and got["similarity"].dtype == torch.float32
    _assert_close(got["similarity"].detach().numpy(), np.asarray(want["similarity"]))
    _assert_close(got["reduce_sim"].detach().numpy(), np.asarray(want["reduce_sim"]))
    emb = got["prompted_embedding"].detach().float().numpy()
    wemb = np.asarray(want["prompted_embedding"].astype(jnp.float32))
    if dtype == torch.bfloat16:  # the prompts are rounded from equal fp32 values
        np.testing.assert_array_equal(emb, wemb)
    else:
        _assert_close(emb, wemb)
    loss = (got["prompted_embedding"].float() * torch.from_numpy(w)).sum()
    (g,) = torch.autograd.grad(loss, [tm.prompt])
    _assert_close(g.numpy(), np.asarray(jgrads["prompt"]))
    assert not np.any(np.asarray(jgrads["prompt_key"]))  # neither package trains the keys
    return got["prompt_idx"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2p_forward_matches_jax(dtype):
    jm, tm = _l2p()
    x = np.random.RandomState(0).randn(5, 9, 16).astype(np.float32)
    params = _carry(jm, tm, jnp.asarray(x))
    idx = _l2p_check(jm, tm, params, x, dtype)
    assert (idx == idx[0]).all()  # the batchwise vote: one choice for the batch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_l2p_count_ties_break_to_the_lower_index_as_in_jax(dtype):
    """Keys along the axes, and a batch whose samples each point at two
    different keys: sample 0 picks {3, 5}, sample 1 {4, 1}, so four entries
    tie at one vote each and `jax.lax.top_k` keeps the lowest two, 1 and
    3; a sort that is not stable, or `torch.topk`, need not."""
    jm, tm = _l2p(pool=6, top_k=2, length=2, dim=8)
    keys = np.zeros((6, 8), np.float32)
    keys[np.arange(6), np.arange(6)] = 1.0
    x = np.zeros((2, 5, 8), np.float32)
    x[0, :, 3], x[0, :, 5] = 1.0, 0.5
    x[1, :, 4], x[1, :, 1] = 1.0, 0.5
    params = _carry(jm, tm, jnp.asarray(x))
    params = {**params, "prompt_key": jnp.asarray(keys)}
    with torch.no_grad():
        tm.prompt_key.copy_(torch.from_numpy(keys))
    idx = _l2p_check(jm, tm, params, x, dtype)
    assert idx.tolist() == [[1, 3], [1, 3]]


def test_l2p_refuses_more_prompt_tokens_than_the_embedding_has():
    jm, tm = _l2p(top_k=3, length=2)
    x = np.zeros((2, 5, 16), np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 9, 16)))["params"]
    with pytest.raises(ValueError):
        jm.apply({"params": params}, jnp.asarray(x))
    with pytest.raises(ValueError, match="do not fit"):
        tm(torch.from_numpy(x))


# ---- the initialisers ---------------------------------------------------------
def _pool_pair(kind, T_=12):
    dims = dict(layer_num=9, prompt_num=16, visual_dim=96, textual_dim=768)
    if kind == "lpi":
        return (jp.DecomposedPromptPool(num_tasks=T_, rank=4, **dims),
                tp.DecomposedPromptPool(T_, 9, 16, 96, 768, 4), (0,))
    if kind == "sprompts":
        return jp.NormalPromptPool(num_tasks=T_, **dims), tp.NormalPromptPool(T_, 9, 16, 96,
                                                                              768), (0,)
    if kind == "maple":
        return jp.MaPLePromptPool(num_tasks=T_, **dims), tp.MaPLePromptPool(T_, 9, 16, 96,
                                                                            768), (0,)
    return (jp.L2pPrompt(pool_size=T_, length=4, embed_dim=768, top_k=4),
            tp.L2pPrompt(pool_size=T_, length=4, embed_dim=768, top_k=4),
            (jnp.zeros((2, 197, 768)),))


# (leaf, distribution, scale): normal std, or uniform bound
INITS = {"lpi": [(n, "normal", 0.5) for n in ("d1_share", "d2_visual", "d2_textual",
                                              "d3_visual", "d3_textual")],
         "sprompts": [("visual_prompt", "normal", 0.02), ("textual_prompt", "normal", 0.02)],
         "maple": [("textual", "normal", 0.02), ("proj_kernel", "uniform", 768 ** -0.5),
                   ("proj_bias", "uniform", 768 ** -0.5)],
         "l2p": [("prompt", "uniform", 1.0), ("prompt_key", "uniform", 1.0)]}


@pytest.mark.parametrize("kind", sorted(INITS))
def test_initialisers_draw_the_jax_distributions(kind):
    """Each leaf's `init_leaf_` draw and the JAX package's initial value:
    mean 0 and the standard deviation of the distribution (sigma, or
    bound/sqrt(3)) within 5 standard errors; uniform draws inside the bound
    and reaching within 1% of it; the two packages' moments alike."""
    jm, tm, args = _pool_pair(kind)
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), *args)["params"])
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            tm.init_leaf_(name, p, gen)
    got = dict(tm.named_parameters())
    assert sorted(got) == sorted(n for n, _, _ in INITS[kind]) == sorted(jparams)
    for name, dist, scale in INITS[kind]:
        sd = scale if dist == "normal" else scale / np.sqrt(3.0)
        for values in (got[name].detach().numpy().ravel(), jparams[name].ravel()):
            n = values.size
            assert abs(values.mean()) < 5 * sd / np.sqrt(n), name
            assert abs(values.std() / sd - 1) < 5 * np.sqrt(0.5 / n) + 1e-3, name
            if dist == "uniform":
                assert np.abs(values).max() <= scale, name
                assert np.abs(values).max() > 0.99 * scale, name
            elif n >= 400:  # not cut at 2 sd, as Flax's `normal` is not
                assert np.abs(values).max() > 2.5 * sd, name


def test_model_initialisers_use_each_pool_s_own():
    """SliNet and the grounding model draw their pools through the pool's
    `init_leaf_`: a dense S-Prompts pool at N(0, 0.02) and MaPLe's
    projections inside +-1/sqrt(Dt), not the CP factors' N(0, 0.5)."""
    import dataclasses

    from lpi_tpu_torch import config as tc
    from lpi_tpu_torch.models.clip import SliNet, init_parameters
    from lpi_tpu_torch.models.glip import grounding as tg
    from tests.test_torch_clip import _cfg

    cfg = _cfg(tc)
    for kind, leaf, bound in (("sprompts", "visual_prompt", None), ("l2p", "prompt", 1.0)):
        m = SliNet(dataclasses.replace(cfg, lpi=dataclasses.replace(cfg.lpi, prompt_type=kind)))
        init_parameters(m, torch.Generator().manual_seed(0))
        p = getattr(m.prompts, leaf).detach()
        if bound is None:
            assert 0.015 < p.std() < 0.025
        else:
            assert p.abs().max() <= bound and p.std() > 0.5
    from tests.test_torch_train import _tiny

    g = _tiny(tc)
    g = dataclasses.replace(g, lpi=dataclasses.replace(g.lpi, prompt_type="maple",
                                                       interact_type="maple", interact=False))
    m = tg.GroundedVLModel(g)
    tg.init_parameters(m, torch.Generator().manual_seed(0))
    assert isinstance(m.prompts, tp.MaPLePromptPool) and m.encoder.interact is None
    bound = g.bert.hidden_size ** -0.5
    for p in (m.prompts.proj_kernel, m.prompts.proj_bias):
        assert 0 < p.abs().max() <= bound
    assert 0.01 < m.prompts.textual.std() < 0.03


@pytest.mark.parametrize("kind", ["lpi", "sprompts", "l2p", "maple", "bogus"])
def test_build_prompt_pool_dispatches_as_jax(kind):
    """"lpi", "sprompts" (one layer whatever `layer_num`) and "l2p" (the
    pool's defaults but its width); "maple" and unknown types are a
    ValueError in both packages."""
    args = (T, L, P, DV, DT)
    if kind in ("maple", "bogus"):
        for build in (jp.build_prompt_pool, tp.build_prompt_pool):
            with pytest.raises(ValueError, match="prompt_type"):
                build(kind, *args)
        return
    j, t = jp.build_prompt_pool(kind, *args), tp.build_prompt_pool(kind, *args)
    assert type(t).__name__ == type(j).__name__
    if kind == "l2p":
        assert (t.pool_size, t.length, t.embed_dim, t.top_k) == (j.pool_size, j.length,
                                                                 j.embed_dim, j.top_k)
    else:
        assert t.all_prompts()[0].shape == (T, j.layer_num, P, DV)
