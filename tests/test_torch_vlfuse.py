"""Early fusion (VLFuse, GLIP's MHA-B): the port against the JAX package.

`BiMultiHeadAttention`, `BiAttentionBlock` and `VLFuse` at tiny widths,
weights carried from the JAX modules by `bridge.params_from_jax`, inputs
from a numpy seed. fp32 outputs and the VJPs with respect to both streams
are held to the repo's bar (relative Frobenius 1e-4 plus an absolute cap);
the global-max batch and the padded-token mask at 1e-5. In bf16 the dtype
of every output is pinned to JAX's (the fused levels and hidden states
leave in fp32: `v + gamma_v * dv` meets an fp32 gamma) and the values are
held to half the JAX module's own bf16-against-fp32 error: two modules that
round at the same points share most of their rounding error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.models.glip import vlfuse as jv
from lpi_tpu_torch.bridge import params_from_jax
from lpi_tpu_torch.models.glip import vlfuse as tv
from tests.test_composed_parity import _assert_close

torch.set_num_threads(1)
V, L, E, H = 16, 36, 32, 4  # visual width, language width (> E), embed, heads
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _carry(module, params):
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return module


def _mask(B, Nl):
    """Padded tokens: the last two of sample 0, the last four of sample 1."""
    m = np.ones((B, Nl), np.float32)
    m[0, -2:] = 0
    if B > 1:
        m[1, -4:] = 0
    return m


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _attention_pair(rng, dtype="float32"):
    jd, td = DT[dtype]
    jm = jv.BiMultiHeadAttention(V, L, E, H, dtype=jd)
    v, l = rng.randn(2, 20, V).astype(np.float32), rng.randn(2, 7, L).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(v), jnp.asarray(l))["params"]
    return jm, params, _carry(tv.BiMultiHeadAttention(V, L, E, H, dtype=td), params)


def _vjp_both(jfn, tfn, inputs, mask, rng, bar):
    """Outputs and the VJPs with respect to every input stream, JAX against
    the port, fp32."""
    jin = [jnp.asarray(x) for x in inputs]
    jm = None if mask is None else jnp.asarray(mask)
    jout, vjp = jax.vjp(lambda *xs: jfn(*xs, jm), *jin)
    cts = jax.tree.map(lambda o: rng.randn(*o.shape).astype(np.float32), jout)
    jgrads = vjp(jax.tree.map(jnp.asarray, cts))
    tin = [torch.tensor(x, requires_grad=True) for x in inputs]
    tout = tfn(*tin, None if mask is None else torch.from_numpy(mask))
    flat_t, flat_j, flat_c = (jax.tree.leaves(x) for x in (tout, jout, cts))
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(flat_t, flat_c)).backward()
    for o, w in zip(flat_t, flat_j):
        _assert_close(o.detach().numpy(), w, rel=bar)
    for t, g in zip(tin, jgrads):
        assert np.abs(np.asarray(g)).max() > 0
        _assert_close(t.grad.numpy(), g, rel=bar)


@pytest.mark.parametrize("masked", [False, True])
def test_bi_attention_and_its_vjp_match_jax(rng, masked):
    jm, params, tm = _attention_pair(rng)
    v, l = rng.randn(2, 20, V).astype(np.float32), rng.randn(2, 7, L).astype(np.float32)
    _vjp_both(lambda a, b, m: jm.apply({"params": params}, a, b, m), tm, (v, l),
              _mask(2, 7) if masked else None, rng, 1e-5 if masked else 1e-4)


def test_padded_tokens_take_no_attention(rng):
    """A padded token's values reach no visual output: changing them moves
    the visual stream by no more than the rounding of the shifted logits;
    the port's output held to JAX's at 1e-5."""
    jm, params, tm = _attention_pair(rng)
    v, l = rng.randn(2, 20, V).astype(np.float32), rng.randn(2, 7, L).astype(np.float32)
    mask = _mask(2, 7)
    l2 = l.copy()
    l2[mask == 0] += 5.0
    with torch.no_grad():
        a, _ = tm(torch.from_numpy(v), torch.from_numpy(l), torch.from_numpy(mask))
        b, _ = tm(torch.from_numpy(v), torch.from_numpy(l2), torch.from_numpy(mask))
    _assert_close(b.numpy(), a.numpy(), rel=1e-6)
    want, _ = jm.apply({"params": params}, *map(jnp.asarray, (v, l2, mask)))
    _assert_close(b.numpy(), want, rel=1e-5)


def test_global_max_couples_the_batch(rng):
    """The stable-softmax shift is the max over the whole batch and every
    head: sample 1's identical tokens, aligned in every head, score about
    1e5, which shifts sample 0's moderate logits below the -50000 clamp.
    Batched, sample 0 then attends uniformly; alone it does not. The port's
    batched result is held to JAX's batched one at 1e-5."""
    jm, params, tm = _attention_pair(rng)
    wv = np.asarray(params["v_proj"]["kernel"])  # [V, E]
    wl = np.asarray(params["l_proj"]["kernel"])  # [L, E]
    d = rng.randn(V).astype(np.float32)
    e = np.linalg.lstsq(wl.T, wv.T @ d, rcond=None)[0].astype(np.float32)  # l_proj(e) = v_proj(d)
    q = wv.T @ d
    scale = np.sqrt(1.2e5 * np.sqrt(E // H) / (q @ q / H))
    v = rng.randn(2, 20, V).astype(np.float32)
    l = rng.randn(2, 7, L).astype(np.float32)
    v[1] = scale * d
    l[1] = scale * e
    mask = _mask(2, 7)
    want = jm.apply({"params": params}, *map(jnp.asarray, (v, l, mask)))
    alone = jm.apply({"params": params}, *map(jnp.asarray, (v[:1], l[:1], mask[:1])))
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (v, l, mask)))
        got_alone = tm(*map(torch.from_numpy, (v[:1], l[:1], mask[:1])))
    for g, w in zip(got, want):
        _assert_close(g.numpy(), w, rel=1e-5)
    for g, w in zip(got_alone, alone):
        _assert_close(g.numpy(), w, rel=1e-5)
    assert _rel(got[0][:1].numpy(), got_alone[0].numpy()) > 1e-2
    assert _rel(np.asarray(want[0][:1]), np.asarray(alone[0])) > 1e-2


def test_bi_attention_block_and_its_vjp_match_jax(rng):
    jm = jv.BiAttentionBlock(V, L, E, H, init_values=0.3)
    v, l = rng.randn(2, 20, V).astype(np.float32), rng.randn(2, 7, L).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(v), jnp.asarray(l))["params"]
    params = jax.tree.map(np.asarray, params)
    params["gamma_v"] = rng.rand(V).astype(np.float32)  # layer scales apart from their init
    params["layer_norm_l"]["scale"] = 1 + 0.1 * rng.randn(L).astype(np.float32)
    tm = _carry(tv.BiAttentionBlock(V, L, E, H), params)
    _vjp_both(lambda a, b, m: jm.apply({"params": params}, a, b, m), tm, (v, l),
              _mask(2, 7), rng, 1e-4)


def _fuse_pair(rng, dtype="float32"):
    jd, td = DT[dtype]
    feats = [rng.randn(2, s, s, V).astype(np.float32) for s in (6, 3, 2)]
    hidden = rng.randn(2, 7, L).astype(np.float32)
    jm = jv.VLFuse(V, L, E, H, init_values=0.5, dtype=jd)
    params = jm.init(jax.random.PRNGKey(2), [jnp.asarray(f) for f in feats],
                     jnp.asarray(hidden))["params"]
    return jm, params, _carry(tv.VLFuse(V, L, E, H, 0.5, td), params), feats, hidden


def test_vlfuse_and_its_vjp_match_jax(rng):
    """Three levels flattened into one sequence and split back; the VJP
    with respect to every level and the hidden states."""
    jm, params, tm, feats, hidden = _fuse_pair(rng)

    def jfn(*xs):
        *fs, h, m = xs
        return jm.apply({"params": params}, list(fs), h, m)

    def tfn(*xs):
        *fs, h, m = xs
        return tm(list(fs), h, m)

    _vjp_both(jfn, tfn, (*feats, hidden), _mask(2, 7), rng, 1e-4)


def test_vlfuse_bf16_dtypes_and_values_match_jax(rng):
    """bf16 inputs and compute: the fused levels and the hidden states leave
    in fp32 in both packages; values within half the JAX module's own
    bf16-against-fp32 error."""
    jm32, params, _, feats, hidden = _fuse_pair(rng)
    jm16 = jv.VLFuse(V, L, E, H, init_values=0.5, dtype=jnp.bfloat16)
    tm = _carry(tv.VLFuse(V, L, E, H, 0.5, torch.bfloat16), params)
    mask = _mask(2, 7)
    f16 = [jnp.asarray(f, jnp.bfloat16) for f in feats]
    h16 = jnp.asarray(hidden, jnp.bfloat16)
    want = jm16.apply({"params": params}, f16, h16, jnp.asarray(mask))
    ref32 = jm32.apply({"params": params}, [f.astype(jnp.float32) for f in f16],
                       h16.astype(jnp.float32), jnp.asarray(mask))
    with torch.no_grad():
        got = tm([torch.from_numpy(np.array(f.astype(jnp.float32))).bfloat16() for f in f16],
                 torch.from_numpy(np.array(h16.astype(jnp.float32))).bfloat16(),
                 torch.from_numpy(mask))
    got_leaves, want_leaves = jax.tree.leaves(got), jax.tree.leaves(want)
    for g, w, r in zip(got_leaves, want_leaves, jax.tree.leaves(ref32)):
        assert w.dtype == jnp.float32 and g.dtype == torch.float32
        own = _rel(np.asarray(w), np.asarray(r))
        assert own > 0
        assert _rel(g.numpy(), np.asarray(w)) <= 0.5 * own
