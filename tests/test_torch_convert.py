"""The weight converters: the port against the JAX package.

`lpi_tpu_torch.models.clip.convert` and `lpi_tpu_torch.models.glip.convert`
map the PyTorch checkpoints straight to the port's state-dict names. On tiny
configs they must give the same tensors, bit for bit, as the JAX converters
followed by `bridge`, and report the same unmapped keys. On the vendored key
manifests (`tests/data/*.manifest.txt`, the exact key and shape namespaces
of the OpenAI CLIP ViT-B/16 and GLIP-T(A) + LPI checkpoints) at full size,
every checkpoint key is consumed or reported unmapped exactly as the JAX
converter reports it, and the output fills every entry it should of the
port's full-width model, built on the meta device, with the exact shape.
"""

import numpy as np
import pytest
import torch
from flax import traverse_util

from lpi_tpu.core import config as jc
from lpi_tpu.models.clip import convert as jclip
from lpi_tpu.models.glip import convert as jglip
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.bridge import params_from_jax, slinet_params_from_jax
from lpi_tpu_torch.continual import learner as tlearner
from lpi_tpu_torch.models.clip import convert as tclip
from lpi_tpu_torch.models.clip.slinet import SliNet
from lpi_tpu_torch.models.glip import convert as tglip
from lpi_tpu_torch.models.glip.grounding import GroundedVLModel
from tests.test_glip_convert import TINY as J_GLIP_TINY
from tests.test_glip_convert import synthetic_glip_sd
from tests.test_manifest_coverage import (ALIAS_PREFIXES, NON_PARAM_PREFIXES,
                                          NON_PARAM_SUFFIXES, load_manifest)

torch.set_num_threads(1)


def _same(got: dict, want: dict):
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for k, v in want.items():
        assert got[k].dtype == torch.float32 == v.dtype, k
        assert tuple(got[k].shape) == tuple(v.shape), k
        assert torch.equal(got[k], v), k


def _clip_cfg(c):
    return c.CLIPConfig(image_resolution=32, patch_size=8, vision_width=64, vision_layers=3,
                        vision_heads=4, text_width=32, text_layers=2, text_heads=4,
                        vocab_size=100, context_length=16, embed_dim=24)


def _tiny_glip():
    """tests/test_glip_convert.py's TINY (tests/test_grounding.py's, with
    the GroupNorm FPN and a 1-channel cls head) in the port's config."""
    return tc.GroundingConfig(
        swin=tc.SwinConfig(patch_size=4, embed_dim=8, depths=(2, 2, 2, 2),
                           num_heads=(1, 2, 2, 2), window_size=4),
        bert=tc.BertConfig(vocab_size=512, hidden_size=16, num_layers=8, num_heads=2,
                           intermediate_size=32, max_position_embeddings=32, max_query_len=16),
        dyhead=tc.DyHeadConfig(num_convs=2, channels=16, max_tokens=16, num_classes=2),
        lpi=tc.LPIPromptConfig(prompt_length=4, prompt_depth=6, prompt_rank=2,
                               interact_rank=2, interact_depth=6),
        fpn_use_gn=True, total_tasks=3, image_size=64, dtype="float32")


# ---- CLIP ---------------------------------------------------------------------
def test_clip_synthetic_state_dict_matches_jax():
    got, want = tclip.synthetic_state_dict(_clip_cfg(tc), 3), \
        jclip.synthetic_state_dict(_clip_cfg(jc), 3)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float16
        np.testing.assert_array_equal(got[k], want[k])


def test_clip_converter_matches_jax_then_bridge():
    """`logit_scale` is 0-d in the checkpoint and in the port's model; the
    bridge widens 0-d arrays to [1] (`np.ascontiguousarray`), a form that
    `load_state_dict` also takes."""
    sd = jclip.synthetic_state_dict(_clip_cfg(jc), 1)
    want = slinet_params_from_jax({"clip": jclip.convert_openai_clip(sd)})
    want["clip.logit_scale"] = want["clip.logit_scale"].reshape(())
    _same(tclip.convert_openai_clip(sd), want)
    _same(tclip.convert_openai_clip({k: torch.from_numpy(v) for k, v in sd.items()}), want)
    with pytest.raises(KeyError):
        tclip.convert_openai_clip({k: v for k, v in sd.items() if k != "visual.proj"})


def test_load_torch_clip_reads_a_plain_state_dict(tmp_path):
    """A plain `torch.save` state dict (not a jit archive) loads, converts
    and seeds a learner."""
    cfg = tc.RetrievalConfig(clip=_clip_cfg(tc), total_sessions=2, dtype="float32",
                             lpi=tc.LPIPromptConfig(prompt_length=4, prompt_depth=2,
                                                    prompt_rank=2))
    sd = tclip.synthetic_state_dict(cfg.clip, 2)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "clip.pt")
    got = tclip.load_torch_clip(str(tmp_path / "clip.pt"))
    _same(got, tclip.convert_openai_clip(sd))
    learner = tlearner.RetrievalLearner(cfg, init_params=got, device="cpu")
    state = learner.model.state_dict()
    assert all(torch.equal(state[k], v) for k, v in got.items())


# ---- GLIP ---------------------------------------------------------------------
def _with_pools(sd, rng, tasks=2):
    """`sd` plus LPI pools of `tasks` tasks in the checkpoint's names."""
    sd = dict(sd)
    for t in range(tasks):
        for name, shape in (("dim_1_share", (6, 2)), ("dim_2_visual", (4, 2)),
                            ("dim_2_textual", (4, 2)), ("dim_3_visual", (8, 2)),
                            ("dim_3_textual", (16, 2))):
            sd[f"module.prompts.{t}.{name}"] = rng.randn(*shape).astype(np.float32)
        p = f"module.language_backbone.body.model.encoder.interactModuleList.{t}."
        for name, shape in (("dim_1_v2t", (6, 2)), ("dim_2_v2t", (9, 2)), ("dim_3_v2t", (16, 2)),
                            ("dim_1_t2v", (6, 2)), ("dim_2_t2v", (17, 2)), ("dim_3_t2v", (8, 2)),
                            ("visual_norm.weight", (8,)), ("visual_norm.bias", (8,)),
                            ("textual_norm.weight", (16,)), ("textual_norm.bias", (16,))):
            sd[p + name] = rng.randn(*shape).astype(np.float32)
    sd["module.rpn.anchor_generator.cell_anchors.0"] = np.zeros((1, 4), np.float32)
    return sd


def test_glip_converter_matches_jax_then_bridge():
    """The tiny GroupNorm-FPN checkpoint with LPI pools and a buffer that
    maps nowhere: the same tensors and the same unmapped keys; every entry
    lands in the port's model with its shape, and every frozen entry of the
    model is filled."""
    sd = _with_pools(synthetic_glip_sd(J_GLIP_TINY, np.random.RandomState(0)),
                     np.random.RandomState(1))
    jflat, junmapped = jglip.convert_glip(sd)
    want = params_from_jax(traverse_util.unflatten_dict(jflat),
                           depths=J_GLIP_TINY.swin.depths)
    got, unmapped = tglip.convert_glip(sd)
    _same(got, want)
    assert unmapped == junmapped == ["rpn.anchor_generator.cell_anchors.0"]
    with torch.device("meta"):
        model = GroundedVLModel(_tiny_glip())
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in got.items()
            if not k.startswith(("prompts.", "encoder.interact."))} == \
        {k: s for k, s in shapes.items() if not k.startswith(("prompts.", "encoder.interact."))}


def test_glip_converter_leaves_bert_layers_past_the_swin_blocks_unmapped():
    sd = synthetic_glip_sd(J_GLIP_TINY, np.random.RandomState(2))
    extra = "module.language_backbone.body.model.encoder.layer.8.output.dense.bias"
    sd[extra] = np.zeros(16, np.float32)
    _, junmapped = jglip.convert_glip(sd)
    got, unmapped = tglip.convert_glip(sd)
    assert unmapped == junmapped == [extra[len("module."):]]
    assert not any(k.startswith("encoder.layers.8.") for k in got)


def test_merge_into_params_overlays_and_skips():
    base = {"a": torch.zeros(2), "b": torch.zeros(3)}
    conv = {"a": torch.ones(2), "b": torch.ones(4), "c": torch.ones(1)}
    with pytest.raises(ValueError, match="shape mismatch at b"):
        tglip.merge_into_params(base, conv)
    merged = tglip.merge_into_params(base, conv, strict_shapes=False)
    assert set(merged) == {"a", "b"}
    assert torch.equal(merged["a"], torch.ones(2)) and torch.equal(merged["b"], torch.zeros(3))
    assert torch.equal(base["a"], torch.zeros(2))


# ---- the vendored manifests, full size ---------------------------------------
def _zeros(manifest):
    """A checkpoint of zeros in the manifest's names and shapes (calloc'd:
    pages are committed only where a converter writes)."""
    return {k: np.zeros(shape, np.float32) for k, shape in manifest.items()}


def test_clip_manifest_fills_every_clip_entry_of_the_full_slinet():
    manifest = load_manifest("clip_vit_b16.manifest.txt")
    got = tclip.convert_openai_clip(_zeros(manifest))
    assert sum(v.numel() for v in got.values()) == \
        sum(int(np.prod(s)) if s else 1 for s in manifest.values())
    with torch.device("meta"):
        model = SliNet(tc.RetrievalConfig())
    want = {k: tuple(v.shape) for k, v in model.state_dict().items() if k.startswith("clip.")}
    assert {k: tuple(v.shape) for k, v in got.items()} == want


def test_glip_manifest_consumed_as_jax_reports_and_fills_the_full_model():
    """Unmapped keys exactly the JAX converter's (and only aliases,
    buffers and anchors among them); the same number of values out as the
    JAX converter; every entry of the full-width `GroundedVLModel` filled
    with its exact shape, the LPI pools of 12 tasks included."""
    manifest = load_manifest("glip_t_lpi.manifest.txt")
    jflat, junmapped = jglip.convert_glip(_zeros(manifest), num_tasks=12)
    j_count = sum(int(np.size(v)) for v in jflat.values())
    del jflat
    got, unmapped = tglip.convert_glip(_zeros(manifest))
    assert unmapped == junmapped
    assert not [k for k in unmapped if not k.startswith(ALIAS_PREFIXES)
                and not k.startswith(NON_PARAM_PREFIXES) and not k.endswith(NON_PARAM_SUFFIXES)]
    assert sum(v.numel() for v in got.values()) == j_count
    with torch.device("meta"):
        model = GroundedVLModel(tc.GroundingConfig())
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in got.items()} == want
