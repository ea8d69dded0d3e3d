"""The head's variants, `VLDyHead` alone: the port against the JAX package.

Early fusion (a VLFuse and a BERT layer before each tower), the towers
without deformable convs, without the attention fusion or without DyReLU,
and a first tower narrower than the head (which drops all three, as the
JAX package's does). Both packages get the same FPN features, text
embeddings and hidden states from a numpy seed and the same weights
(`bridge.params_from_jax`); the head needs no Swin or BERT compile. Head
outputs and the gradients with respect to every input (which carry the
pools' gradient in the model) are held to the repo's bar, relative
Frobenius 1e-4 plus an absolute cap. The variants of the fusion and the
activation run beside plain convs here: JAX compiles a deformable conv's
gradient slowly on the CPU (40-60 s a tower), and the deformable towers are
held with them in the whole model (`tests/test_torch_early_fusion.py`).
Then the offset-clip record against JAX's sown `offset_clip_frac` on the
windowed route (JAX's "fast_scan", the Pallas kernel's function in XLA,
against the port's window kernel's plain version), and the bf16 dtypes at
every tower boundary of an early-fused deformable head. The "exact" route
is in `tests/test_torch_head_exact.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.core import config as jc
from lpi_tpu.models.glip.vldyhead import VLDyHead as JHead
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.bridge import params_from_jax
from lpi_tpu_torch.models.glip.vldyhead import Conv3x3Norm, VLDyHead
from tests.test_composed_parity import _assert_close

torch.set_num_threads(1)
C, D, T = 16, 16, 6  # head channels, language width, tokens
KEYS = ("bbox_pred", "centerness", "dot_logits")
BERT = dict(vocab_size=64, hidden_size=D, num_layers=2, num_heads=2, intermediate_size=32,
            max_position_embeddings=32)
FUSE = dict(early_fuse=True, fuse_embed_dim=32, fuse_heads=4)
PLAIN = dict(use_dfconv=False)
CASES = {
    # name: (DyHeadConfig fields, input width, level sides)
    "early_fuse": (dict(num_convs=2, **FUSE, **PLAIN), C, (8, 4, 2)),
    "no_dfconv": (dict(num_convs=2, **PLAIN), C, (7, 4, 2)),
    "no_dyfuse": (dict(num_convs=1, use_dyfuse=False, **PLAIN), C, (8, 4, 2)),
    "no_dyrelu": (dict(num_convs=1, use_dyrelu=False, **PLAIN), C, (8, 4, 2)),
    "narrow_input": (dict(num_convs=2, **PLAIN), 8, (8, 4, 2)),
}


def _cfg(module, fields):
    return module.DyHeadConfig(channels=C, **{"deform_impl": "fast_scan", **fields})


def _inputs(rng, in_ch, sides, B=2):
    feats = [rng.randn(B, s, s, in_ch).astype(np.float32) for s in sides]
    emb = rng.randn(B, T, D).astype(np.float32)
    emb[:, 4:] = 0.0
    hidden = rng.randn(B, T, D).astype(np.float32)
    masks = np.array([[1, 1, 1, 1, 0, 0]] * B, np.float32)
    return feats, emb, hidden, masks


def _scaled(params, s):
    """The offset convs' parameters times `s` (larger offsets)."""
    return jax.tree_util.tree_map_with_path(
        lambda p, v: v * s if "offset" in jax.tree_util.keystr(p) else v, params)


def _heads(fields, in_ch, sides, scale, rng, dtype="float32"):
    """The JAX head, its parameters (offset convs times `scale`), the port's
    head on them, and the inputs."""
    bert = jc.BertConfig(**BERT) if fields.get("early_fuse") else None
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jh = JHead(_cfg(jc, fields), lang_dim=D, dtype=jd, bert_cfg=bert)
    feats, emb, hidden, masks = _inputs(rng, in_ch, sides)
    jargs = ([jnp.asarray(f) for f in feats], jnp.asarray(emb), jnp.asarray(masks),
             jnp.asarray(hidden))
    params = _scaled(jax.jit(jh.init)(jax.random.PRNGKey(0), *jargs)["params"], scale)
    state = params_from_jax({"head": jax.tree.map(np.asarray, params)})
    th = VLDyHead(_cfg(tc, fields), lang_dim=D, num_levels=len(sides),
                  dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32,
                  bert_cfg=tc.BertConfig(**BERT) if bert else None, in_channels=in_ch)
    th.load_state_dict({k[len("head."):]: v for k, v in state.items()}, strict=True)
    return jh, params, th, (feats, emb, masks, hidden)


@pytest.mark.parametrize("case", list(CASES))
def test_head_variant_and_its_gradients_match_jax(rng, case):
    fields, in_ch, sides = CASES[case]
    jh, params, th, (feats, emb, masks, hidden) = _heads(fields, in_ch, sides, 1.0, rng)
    hold_head(jh, params, th, feats, emb, masks, hidden, rng)


def hold_head(jh, params, th, feats, emb, masks, hidden, rng):
    """Head outputs and the gradients with respect to the features, the
    embeddings and (where early fusion reads them) the hidden states, JAX
    against the port, at the repo's bar. The padded tokens' embedding
    gradient is about 1e6 (the eps inside the normalising rsqrt), so its
    absolute cap is scaled by its largest value."""
    shapes = jax.eval_shape(lambda: jh.apply({"params": params}, [jnp.asarray(f) for f in feats],
                                             jnp.asarray(emb), jnp.asarray(masks),
                                             jnp.asarray(hidden)))
    cts = {k: [rng.randn(*o.shape).astype(np.float32) for o in shapes[k]] for k in KEYS}

    def loss(fs, e, h):
        out = jh.apply({"params": params}, fs, e, jnp.asarray(masks), h)
        return sum(jnp.vdot(o, c) for k in KEYS for o, c in zip(out[k], cts[k])), out

    (_, want), want_grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        [jnp.asarray(f) for f in feats], jnp.asarray(emb), jnp.asarray(hidden))
    tf = [torch.tensor(f, requires_grad=True) for f in feats]
    te, thid = torch.tensor(emb, requires_grad=True), torch.tensor(hidden, requires_grad=True)
    got = th(tf, te, torch.from_numpy(masks), thid)
    sum((o * torch.from_numpy(c)).sum() for k in KEYS for o, c in zip(got[k], cts[k])).backward()
    for k in KEYS:
        for g, w in zip(got[k], want[k]):
            _assert_close(g.detach().numpy(), w)
    for t, w in zip(tf, want_grads[0]):
        assert np.abs(np.asarray(w)).max() > 0
        _assert_close(t.grad.numpy(), w)
    valid = masks[0] > 0
    we = np.asarray(want_grads[1])
    _assert_close(te.grad.numpy()[:, valid], we[:, valid])
    _assert_close(te.grad.numpy()[:, ~valid], we[:, ~valid],
                  atol=3e-3 * np.abs(we[:, ~valid]).max())
    if th.cfg.early_fuse:  # the hidden states reach the towers through VLFuse
        assert np.abs(np.asarray(want_grads[2])).max() > 0
        _assert_close(thid.grad.numpy(), want_grads[2])
    else:
        assert thid.grad is None


def test_variants_build_what_the_jax_package_builds(rng):
    """No deformable conv: no offset conv and a plain `conv` in each
    Conv3x3Norm; no fusion or DyReLU: neither module; the narrow first
    tower drops all three; early fusion: a VLFuse and a BERT layer a tower.
    Every JAX leaf is carried and every port parameter receives one (the
    strict load in `_heads`)."""
    built = {}
    for case in ("no_dfconv", "narrow_input", "early_fuse"):
        fields, in_ch, sides = CASES[case]
        built[case] = _heads(fields, in_ch, sides, 1.0, rng)[2]
    t0, t1 = built["no_dfconv"].towers
    assert t0.offset is None and not hasattr(t0.conv_same, "weight")
    assert t0.conv_same.conv.weight.shape == (C, C, 3, 3)
    t0, t1 = built["narrow_input"].towers
    assert (t0.offset, t0.attn, t0.dyrelu) == (None, None, None)
    assert t0.conv_down.conv.weight.shape == (C, 8, 3, 3)
    assert t1.attn is not None and t1.dyrelu is not None
    head = built["early_fuse"]
    assert len(head.fuses) == len(head.langs) == len(head.towers) == 2


def test_offset_clip_record_matches_the_sown_fractions(rng):
    """Each windowed conv's share of offsets beyond +-deform_window, before
    the stride's subsampling, in call order, against JAX's sown
    `offset_clip_frac` (per module, in call order): equal at the seeded
    offsets (all 0) and with the offset convs scaled by 100 (offsets past
    the window), where the largest reads more than 0.1. Outside the
    context nothing is recorded; the "exact" route records nothing, as
    JAX's sows nothing."""
    jh, params, th, (feats, emb, masks, _) = _heads(dict(num_convs=1), C, (8, 4), 1.0, rng)
    jf = [jnp.asarray(f) for f in feats]
    sow = jax.jit(lambda p: jh.apply({"params": p}, jf, jnp.asarray(emb), jnp.asarray(masks),
                                     mutable=["intermediates"])[1]["intermediates"]["tower0"])
    tf = [torch.from_numpy(f) for f in feats]
    for scale in (1.0, 100.0):
        p = _scaled(params, scale)
        sown = {n: list(v["offset_clip_frac"]) for n, v in sow(p).items()}
        want = [sown["conv_same"][0], sown["conv_up"][0], sown["conv_same"][1],
                sown["conv_down"][0]]  # the call order: per level, same, down, up
        th.load_state_dict({k[len("head."):]: v for k, v in params_from_jax(
            {"head": jax.tree.map(np.asarray, p)}).items()})
        with torch.no_grad(), th.record_offset_clipping() as fracs:
            th(tf, torch.from_numpy(emb), torch.from_numpy(masks))
        got = [float(f) for f in fracs]
        np.testing.assert_allclose(got, np.asarray(want, np.float64), rtol=0, atol=1e-6)
        assert (max(got) > 0.1) if scale > 1 else (max(got) == 0.0)
    assert all(m.clip_record is None for m in th.modules() if isinstance(m, Conv3x3Norm))
    exact = VLDyHead(dataclasses.replace(th.cfg, deform_impl="exact"), lang_dim=D, num_levels=2)
    exact.load_state_dict(th.state_dict())
    with torch.no_grad(), exact.record_offset_clipping() as fracs:
        exact(tf, torch.from_numpy(emb), torch.from_numpy(masks))
    assert fracs == []


def test_early_fusion_bf16_dtypes_at_every_tower_boundary(rng):
    """In a bf16 head VLFuse returns the levels and the hidden states in
    fp32 (the layer scale is fp32), so the deformable tower's offset conv
    reads fp32; the BERT layer returns bf16 and the tower bf16, in both
    packages. The port's bf16 outputs are held to JAX's fp32 ones within
    twice the JAX head's own bf16-against-fp32 error (relative Frobenius),
    the repo's bar for a bf16 model (`tests/test_torch_grounding_bf16.py`):
    a VLFuse and a BERT layer round far more often than the plain head, and
    the two packages' products, summed in other orders, round apart.
    JAX's "fast_scan" keeps its product maps in fp32, so the port's are
    asked for in fp32 too (`deform_dtype`)."""
    fields = dict(num_convs=1, deform_dtype="float32", **FUSE)  # a deformable tower
    jh, params, th, (feats, emb, masks, hidden) = _heads(fields, C, (8, 4), 1.0, rng,
                                                         "bfloat16")
    as16 = [jnp.asarray(f, jnp.bfloat16) for f in feats]
    e16, h16 = jnp.asarray(emb, jnp.bfloat16), jnp.asarray(hidden, jnp.bfloat16)
    want, state = jax.jit(lambda: jh.apply({"params": params}, as16, e16, jnp.asarray(masks),
                                           h16, capture_intermediates=True,
                                           mutable=["intermediates"]))()
    jh32 = JHead(_cfg(jc, fields), lang_dim=D, bert_cfg=jc.BertConfig(**BERT))
    ref = jax.jit(lambda: jh32.apply({"params": params}, [f.astype(jnp.float32) for f in as16],
                                     e16.astype(jnp.float32), jnp.asarray(masks),
                                     h16.astype(jnp.float32)))()
    inter = state["intermediates"]
    seen = {}
    hooks = [m.register_forward_hook(lambda m, a, out, name=name: seen.__setitem__(name, out))
             for name, m in [*((f"fuse{i}", f) for i, f in enumerate(th.fuses)),
                             *((f"lang{i}", f) for i, f in enumerate(th.langs)),
                             *((f"tower{i}", f) for i, f in enumerate(th.towers))]]

    def t16(a):
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()

    with torch.no_grad():
        got = th([t16(f) for f in as16], t16(e16), torch.from_numpy(masks), t16(h16))
    for h in hooks:
        h.remove()
    for name, out in seen.items():
        jd = [str(x.dtype) for x in jax.tree.leaves(inter[name]["__call__"])]
        td = [str(x.dtype).replace("torch.", "") for x in jax.tree.leaves(out)]
        assert td == jd, name
    assert {str(x.dtype) for x in jax.tree.leaves(inter["fuse0"]["__call__"])} == {"float32"}
    for k in KEYS:
        w = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in want[k]])
        r = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in ref[k]])
        g = np.concatenate([np.ravel(x.double().numpy()) for x in got[k]])
        own = np.linalg.norm(w - r) / np.linalg.norm(r)
        assert 0 < np.linalg.norm(g - r) / np.linalg.norm(r) <= 2 * own, k
