"""The detector zoo's backbones, the port against the JAX package.

ResNet, the standalone Swin tower, Swin v2 and VL, EfficientNet-BiFPN and
FBNet at tiny widths, the weights carried from Flax by
`bridge.zoo_params_from_jax` (drawn with numpy from their shapes, every
leaf off any constant, so a scale, bias or table carried wrong shows), the
same numpy inputs through both. fp32 at the repo's bar (relative Frobenius
1e-4 with an absolute cap of 3e-3, `tests/test_composed_parity.py:57`);
ResNet in bf16 at twice the JAX package's own bf16-against-fp32 error
(the two packages round in different places; see
`tests/test_torch_grounding_bf16.py`). Also `mixed_operation_random` in its
three modes, the backbone registry and its unknown-name error, and every
public name of the twelve JAX zoo modules (and the shared names the zoo
needs from modules ported earlier) present in the port's module of the
same path.
"""

import importlib
import inspect
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.models.glip import efficientnet as jeff
from lpi_tpu.models.glip import fbnet as jfb
from lpi_tpu.models.glip import resnet as jres
from lpi_tpu.models.glip import swin as jswin
from lpi_tpu.models.glip import swin_variants as jsv
from lpi_tpu_torch.bridge import zoo_params_from_jax
from lpi_tpu_torch.models.glip import efficientnet as teff
from lpi_tpu_torch.models.glip import fbnet as tfb
from lpi_tpu_torch.models.glip import resnet as tres
from lpi_tpu_torch.models.glip import swin as tswin
from lpi_tpu_torch.models.glip import swin_variants as tsv

torch.set_num_threads(1)
SWIN = dict(embed_dim=8, depths=(2, 2), num_heads=(1, 2), window_size=4)
TINY_FBNET = ((3, 1, 1, 8, 1), (3, 2, 6, 8, 2), (5, 2, 3, 16, 1), (5, 2, 3, 16, 1),
              (3, 1, 3, 24, 1), (5, 2, 3, 24, 2), (3, 1, 3, 32, 1))


def close(ours, theirs, rel=1e-4, atol=3e-3):
    """Relative Frobenius error <= rel and every element within atol."""
    ours = np.asarray(ours, np.float64)
    theirs = np.asarray(theirs, np.float64)
    assert ours.shape == theirs.shape
    frob = np.linalg.norm(ours - theirs) / max(np.linalg.norm(theirs), 1e-6)
    assert frob <= rel, f"relative Frobenius error {frob:.3e} > {rel}"
    np.testing.assert_allclose(ours, theirs, atol=atol, rtol=0)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def seeded(shapes, seed=1):
    """Flax params of the given shapes drawn with numpy (no JAX init to
    compile): kernels N(0, 1 / fan-in), the fan-in every axis but the last
    (conv HWIO, transposed-conv HWIO, Dense [in, out]); norm and frozen-BN
    scales, BiFPN's fusion weights and the per-level scales 1 + N(0, 0.1^2);
    biases N(0, 0.05^2); the Swin bias tables N(0, 0.02^2). Every leaf is
    off any constant, so one carried wrong changes the outputs."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path).rsplit("'", 2)[-2]
        shape = leaf.shape
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "w_td", "w_bu", "scales"):
            v = 1 + 0.1 * rng.randn(*shape)
        elif name == "bias":
            v = 0.05 * rng.randn(*shape)
        else:  # the relative-position, i2t and t2t bias tables
            v = 0.02 * rng.randn(*shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def carried(jmod, tmod, *inputs, seed=1):
    """Flax params for `jmod` on `inputs` (`seeded`), carried into the port
    module by the bridge -> (JAX params, port module)."""
    params = seeded(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *inputs)["params"], seed)
    state = zoo_params_from_jax(params)
    missing, unexpected = tmod.load_state_dict(state, strict=False)
    assert not unexpected, unexpected
    assert not [k for k in missing if not k.endswith("relative_position_index")], missing
    return params, tmod


def apply(jmod, params, *inputs):
    return jax.jit(jmod.apply)({"params": params}, *inputs)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def images(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def hold_levels(ours, theirs, **kw):
    assert len(ours) == len(theirs)
    for o, th in zip(ours, theirs):
        close(o.detach().float().numpy(), np.asarray(th, np.float32), **kw)


@pytest.fixture(scope="module")
def resnet():
    """A tiny ResNet's input, Flax params and JAX fp32 levels."""
    x = images((2, 36, 44, 3))
    jm = jres.ResNet(blocks=(1, 1, 1, 1), base_width=8)
    params = seeded(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"])
    return x, params, apply(jm, params, x)


@torch.no_grad()
def test_resnet_matches_jax(resnet):
    x, params, theirs = resnet
    tm = tres.ResNet(blocks=(1, 1, 1, 1), base_width=8)
    tm.load_state_dict(zoo_params_from_jax(params))
    ours = tm(t(x))
    assert [o.shape[1:3] for o in ours] == [(5, 6), (3, 3), (2, 2)]
    hold_levels(ours, theirs)


@torch.no_grad()
def test_resnet_bf16_within_twice_jax_own_bf16_error(resnet):
    x, params, theirs32 = resnet
    j16 = jres.ResNet(blocks=(1, 1, 1, 1), base_width=8, dtype=jnp.bfloat16)
    tm = tres.ResNet(blocks=(1, 1, 1, 1), base_width=8, dtype=torch.bfloat16)
    tm.load_state_dict(zoo_params_from_jax(params))
    theirs16 = apply(j16, params, x)
    ours = tm(t(x))
    for o, a, b in zip(ours, theirs16, theirs32):
        assert o.dtype == torch.float32 and a.dtype == jnp.float32  # frozen BN promotes
        own = rel_err(np.asarray(a, np.float32), np.asarray(b))
        err = rel_err(o.numpy(), np.asarray(a, np.float32))
        print(f"bf16: port vs JAX {err:.3e}, JAX's own {own:.3e}")
        assert 0 < own and err <= 2 * own


@torch.no_grad()
@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 36, 44, 3)])
def test_standalone_swin_matches_jax(shape):
    x = images(shape)
    jm = jswin.SwinTransformer(**SWIN, out_stages=(2, 3))
    params, tm = carried(jm, tswin.SwinTransformer(**SWIN, out_stages=(2, 3)), x)
    hold_levels(tm(t(x)), apply(jm, params, x))


@torch.no_grad()
def test_swin_v2_matches_jax():
    x = images((2, 36, 44, 3))
    jm = jsv.SwinTransformerV2(**SWIN, out_stages=(2, 3))
    params, tm = carried(jm, tsv.SwinTransformerV2(**SWIN, out_stages=(2, 3)), x)
    ours = tm(t(x))
    assert [o.shape[1:3] for o in ours] == [(9, 11), (5, 6)]
    hold_levels(ours, apply(jm, params, x))


@torch.no_grad()
def test_conv_embed_matches_jax():
    x = images((1, 30, 35, 3))
    jm = jsv.ConvEmbed(embed_dim=8)
    params, tm = carried(jm, tsv.ConvEmbed(embed_dim=8), x)
    (a, h, w), (b, hb, wb) = tm(t(x)), apply(jm, params, x)
    assert (h, w) == (hb, wb) == (7, 9)
    close(a.numpy(), b)


@torch.no_grad()
def test_swin_vl_matches_jax_with_padded_text():
    x = images((2, 32, 40, 3))
    rng = np.random.RandomState(3)
    text = rng.randn(2, 8, 16).astype(np.float32)
    mask = np.ones((2, 8), np.float32)
    mask[0, 5:] = 0
    mask[1, 7:] = 0
    kw = dict(**SWIN, out_stages=(2, 3), text_dim=16, max_text_len=8)
    jm = jsv.SwinTransformerVL(**kw)
    params, tm = carried(jm, tsv.SwinTransformerVL(**kw), x, text, mask)
    theirs, theirs_text = apply(jm, params, x, text, mask)
    ours, ours_text = tm(t(x), t(text), t(mask))
    hold_levels(ours, theirs)
    close(ours_text.numpy(), theirs_text)
    # the text mask reaches the image: other padding, other features
    mask2 = mask.copy()
    mask2[0, 4] = 0
    moved, _ = tm(t(x), t(text), t(mask2))
    assert not torch.allclose(moved[0][0], ours[0][0])


@torch.no_grad()
def test_efficientnet_bifpn_matches_jax():
    """Two 100 x 84 images give levels 13x11, 7x6, 4x3, 2x2, 1x1: down's
    stride floors to 1 from 13 to 7 (and 11 to 6) and the crop does the
    work; from 7x6 to 4x3 it is 1 in H and 2 in W."""
    x = images((2, 100, 84, 3))
    kw = dict(channels=16, num_bifpn=2, width_mult=0.25, depth_mult=0.34)
    jm = jeff.EfficientNetBiFPN(**kw)
    params, tm = carried(jm, teff.EfficientNetBiFPN(**kw), x)
    ours = tm(t(x))
    assert [o.shape[1:3] for o in ours] == [(13, 11), (7, 6), (4, 3), (2, 2), (1, 1)]
    hold_levels(ours, apply(jm, params, x))


@torch.no_grad()
def test_fbnet_matches_jax():
    x = images((2, 40, 36, 3))
    jm = jfb.FBNet(stages=TINY_FBNET)
    params, tm = carried(jm, tfb.FBNet(stages=TINY_FBNET), x)
    hold_levels(tm(t(x)), apply(jm, params, x))


def test_fbnet_c_stages_are_jax():
    assert tfb.FBNET_C_STAGES == jfb.FBNET_C_STAGES
    assert teff.B0_STAGES == jeff.B0_STAGES
    for c in (8, 20, 33, 57.6, 320 * 1.1):
        assert teff._round_channels(c) == jeff._round_channels(c)


@pytest.mark.parametrize("path", [None, 1, [2, 0, 1, 2]])
def test_mixed_operation_random_matches_jax(path):
    """The mean of the ops, one op, or one op per sample."""
    x = images((4, 3, 5))
    jops = [lambda v: v * 2.0, lambda v: v + 1.0, jnp.tanh]
    tops = [lambda v: v * 2.0, lambda v: v + 1.0, torch.tanh]
    per_sample = isinstance(path, list)
    theirs = jfb.mixed_operation_random(jops, jnp.asarray(x),
                                        jnp.asarray(path) if per_sample else path)
    ours = tfb.mixed_operation_random(tops, t(x), torch.tensor(path) if per_sample else path)
    close(ours.numpy(), theirs, rel=1e-6, atol=1e-6)


def _shapes(jmod, *inputs):
    """Flax params of `jmod` as zeros, from shapes alone (no compile)."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *inputs)["params"]
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


@pytest.mark.parametrize("name", ["resnet50-fpn", "swint-fpn-retinanet"])
def test_build_backbone_builds_the_jax_backbone(name):
    """Each name builds the port of what the JAX registry builds: the same
    parameters, name for name and shape for shape (ResNet-50 at full width,
    the Swin tower with out_stages 2-5)."""
    cfg = SimpleNamespace(swin=SimpleNamespace(patch_size=4, embed_dim=8, depths=(2, 2, 2, 2),
                                               num_heads=(1, 1, 2, 2), window_size=4,
                                               mlp_ratio=2.0))
    jm = jres.build_backbone(name, cfg)
    tm = tres.build_backbone(name, cfg)
    assert type(tm).__name__ == type(jm).__name__
    x = np.zeros((1, 64, 64, 3), np.float32)
    want = {k: tuple(v.shape) for k, v in zoo_params_from_jax(_shapes(jm, x)).items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    if name == "swint-fpn-retinanet":
        assert tm.out_stages == jm.out_stages == (2, 3, 4, 5)
        assert len(tm(torch.zeros(1, 64, 64, 3))) == 4


def test_build_backbone_refuses_an_unknown_name():
    with pytest.raises(ValueError) as theirs:
        jres.build_backbone("vgg16", None)
    with pytest.raises(ValueError) as ours:
        tres.build_backbone("vgg16", None)
    assert str(ours.value) == str(theirs.value)
    assert sorted(tres.BACKBONES) == sorted(jres.BACKBONES)


# -- every public name of the zoo's JAX modules has its counterpart ---------

ZOO = ("models.glip.resnet", "models.glip.swin_variants", "models.glip.efficientnet",
       "models.glip.fbnet", "models.glip.fcos", "models.glip.retina",
       "models.glip.atss_head", "models.glip.roi_heads", "models.glip.roi_mask_keypoint",
       "ops.roi_align", "ops.deform_pool", "native")
SHARED = {"ops.focal": ("sigmoid_focal_loss",), "ops.boxes": ("box_giou",),
          "ops.nms": ("nms_mask", "soft_nms", "nms_padded"),
          "models.glip.swin": ("SwinTransformer",)}


def public_names(module) -> set:
    """Names the module defines (functions, classes, constants), not ones
    it imports."""
    return {name for name, obj in vars(module).items()
            if not name.startswith("_") and not inspect.ismodule(obj)
            and getattr(obj, "__module__", module.__name__) == module.__name__}


@pytest.mark.parametrize("path", ZOO)
def test_the_port_has_every_public_name_of_the_zoo_module(path):
    theirs = public_names(importlib.import_module(f"lpi_tpu.{path}"))
    ours = vars(importlib.import_module(f"lpi_tpu_torch.{path}"))
    assert theirs, path
    assert sorted(theirs - set(ours)) == []


@pytest.mark.parametrize("path", sorted(SHARED))
def test_the_port_has_the_shared_names_the_zoo_needs(path):
    names = SHARED[path]
    assert set(names) <= public_names(importlib.import_module(f"lpi_tpu.{path}"))
    ours = public_names(importlib.import_module(f"lpi_tpu_torch.{path}"))
    assert sorted(set(names) - ours) == []
