"""`lpi_tpu_torch.core.mesh` against `lpi_tpu.core.mesh`.

* The mesh's shape rules and errors (no group is started for these).
* The tensor-parallel layouts: for every parameter that `bridge` maps from
  a tiny SliNet and a tiny GLIP (the dry run's configs; GLIP also with
  early fusion, whose BERT layers the JAX rules touch), the dim that the
  port shards equals the one JAX's `tp_param_shardings` shards, carried
  through the bridge's own transposes and splits.
* A retrieval session on a 2x2 (data, model) mesh of 4 gloo ranks against
  the JAX learner on a 2x2 mesh of its virtual devices: the losses within
  relative 2e-4 (`tests/test_mesh_tp.py`'s bar) and each pool leaf at the
  repo's bar; two grounding steps on the 2x2 mesh against the port's one
  process on the whole batch within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.continual.learner import RetrievalLearner as JRetrievalLearner
from lpi_tpu.core import config as jc
from lpi_tpu.core import mesh as jmesh
from lpi_tpu.data.retrieval import RetrievalTrainSet as JRetrievalTrainSet
from lpi_tpu_torch import config as tc
from lpi_tpu_torch import dryrun
from lpi_tpu_torch.bridge import params_from_jax, slinet_params_from_jax
from lpi_tpu_torch.core import mesh as tmesh
from lpi_tpu_torch.models.clip.slinet import SliNet
from lpi_tpu_torch.models.glip.grounding import GroundedVLModel
from tests import torch_dist_workers as workers
from tests.test_composed_parity import _assert_close

torch.set_num_threads(1)


def jax_config(cfg, kind: str):
    """The JAX package's config equal to the port's `cfg`."""
    base = jc.RetrievalConfig() if kind == "retrieval" else jc.GroundingConfig()
    return jc._update_dataclass(base, tc.to_dict(cfg))


def jax_session(cfg, dp: int, mp: int = 1):
    """The JAX learner's session on the dry run's set over a (dp, mp) mesh.
    -> (its initial parameters by the port's names, its metrics, its pools
    after, by the port's names)."""
    mesh = jmesh.make_mesh(jc.MeshConfig(data_parallel=dp, model_parallel=mp))
    learner = JRetrievalLearner(jax_config(cfg, "retrieval"), mesh=mesh)
    init = slinet_params_from_jax(jax.tree.map(np.asarray, learner.params))
    ours = dryrun.tiny_retrieval_set(cfg)
    metrics = learner.train_session(JRetrievalTrainSet(ours.images, ours.token_ids, 0), epochs=1)
    after = slinet_params_from_jax(jax.tree.map(np.asarray, learner.params))
    return init, metrics, after


def leaf_close(ours, theirs, name):
    """`_assert_close` (relative Frobenius 1e-4, absolute cap 3e-3), naming
    the leaf."""
    try:
        _assert_close(ours, theirs)
    except AssertionError as e:
        raise AssertionError(f"{name}: {e}") from None


def hold_session(ours, theirs, rel):
    """Losses within `rel`, each pool leaf at the repo's bar."""
    m, (_, jm, after) = ours["metrics"], theirs
    for k in ("total", "base_loss", "alignment_loss", "task_loss"):
        assert m[k] == pytest.approx(float(jm[k]), rel=rel, abs=1e-7), k
    for name, p in ours["pools"].items():
        leaf_close(p, after[name].numpy(), name)


# ---- shapes and errors --------------------------------------------------------
def test_mesh_shape_rules_and_errors():
    assert tmesh.mesh_shape(tc.MeshConfig(), 8) == (8, 1)
    assert tmesh.mesh_shape(tc.MeshConfig(model_parallel=2), 8) == (4, 2)
    assert tmesh.mesh_shape(tc.MeshConfig(data_parallel=2, model_parallel=2), 4) == (2, 2)
    with pytest.raises(ValueError, match="mesh 4x2 needs 8 devices, have 4"):
        tmesh.mesh_shape(tc.MeshConfig(data_parallel=4, model_parallel=2), 4)
    with pytest.raises(ValueError, match="leaves 2 of 4 ranks out"):
        tmesh.mesh_shape(tc.MeshConfig(data_parallel=2), 4)
    with pytest.raises(RuntimeError, match="started process group"):
        tmesh.make_mesh(tc.MeshConfig())


def test_oversubscription_raises_as_in_jax():
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        jmesh.make_mesh(jc.MeshConfig(data_parallel=8, model_parallel=2))
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        tmesh.mesh_shape(tc.MeshConfig(data_parallel=8, model_parallel=2), 8)


# ---- tensor-parallel layouts ---------------------------------------------------
def _coded(shapes, shardings):
    """Per JAX leaf, an array that varies along its sharded axis alone
    (zeros when replicated), so that the sharded dim survives the
    bridge's transposes and splits."""
    def code(leaf, sharding):
        spec = tuple(sharding.spec) + (None,) * (len(leaf.shape) - len(sharding.spec))
        out = np.zeros(leaf.shape, np.float32)
        for axis, name in enumerate(spec):
            if name == "model":
                shape = [1] * len(leaf.shape)
                shape[axis] = leaf.shape[axis]
                out = out + 1 + np.arange(leaf.shape[axis], dtype=np.float32).reshape(shape)
        return out

    return jax.tree.map(code, shapes, shardings)


def _sharded_dim(t: torch.Tensor):
    dims = [d for d in range(t.dim()) if t.shape[d] > 1
            and not torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
    assert len(dims) <= 1
    return dims[0] if dims else None


def _jax_layout(model, args, to_port):
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))["params"]
    mesh = jmesh.make_mesh(jc.MeshConfig(data_parallel=4, model_parallel=2))
    state = to_port(_coded(shapes, jmesh.tp_param_shardings(mesh, shapes)))
    return {name: _sharded_dim(t) for name, t in state.items()}


def _slinet_layouts():
    from lpi_tpu.models.clip import SliNet as JSliNet

    cfg = dryrun.tiny_retrieval_config(2)
    r = cfg.clip.image_resolution
    args = (jnp.zeros((2, r, r, 3)), jnp.zeros((2, cfg.clip.context_length), jnp.int32), 0)
    return (_jax_layout(JSliNet(jax_config(cfg, "retrieval")), args, slinet_params_from_jax),
            tmesh.tp_param_shardings(SliNet(cfg), 2))


def _glip_layouts(early_fuse):
    from lpi_tpu.models.glip.grounding import GroundedVLModel as JModel

    cfg = dryrun.tiny_grounding_config(2)
    if early_fuse:
        cfg = _early_fused(cfg)
    s, q = cfg.image_size, cfg.bert.max_query_len
    args = (jnp.zeros((2, s, s, 3)), jnp.zeros((2, q), jnp.int32), jnp.ones((2, q), jnp.int32), 0)
    return (_jax_layout(JModel(jax_config(cfg, "grounding")), args,
                        lambda p: params_from_jax(p, cfg.swin.depths)),
            tmesh.tp_param_shardings(GroundedVLModel(cfg), 2))


@pytest.mark.parametrize("model", ["slinet", "glip", "glip_early_fused"])
def test_tp_layouts_equal_jax_for_every_bridged_parameter(model):
    theirs, ours = (_slinet_layouts() if model == "slinet"
                    else _glip_layouts(model == "glip_early_fused"))
    assert set(theirs) <= set(ours)
    assert {n: ours[n] for n in theirs} == theirs
    sharded = {n for n, d in theirs.items() if d is not None}
    # both kinds appear, and the packed projections stay whole
    assert {0, 1} <= {theirs[n] for n in sharded}
    assert not any(k in n for n in sharded for k in ("in_proj", "qkv"))


def test_tp_rules_by_name():
    assert tmesh.tp_dim("clip.visual.transformer.0.mlp_c_fc.weight", (256, 64), 2) == 0
    assert tmesh.tp_dim("clip.visual.transformer.0.mlp_c_fc.bias", (256,), 2) == 0
    assert tmesh.tp_dim("clip.visual.transformer.0.mlp_c_proj.weight", (64, 256), 2) == 1
    assert tmesh.tp_dim("clip.visual.transformer.0.mlp_c_proj.bias", (64,), 2) is None
    assert tmesh.tp_dim("encoder.layers.3.attention.query.weight", (16, 16), 2) == 0
    assert tmesh.tp_dim("head.langs.0.attention.query.weight", (16, 16), 2) is None
    assert tmesh.tp_dim("clip.visual.transformer.0.mlp_c_fc.weight", (100, 64), 8) is None
    assert tmesh.tp_dim("clip.visual.transformer.0.mlp_c_fc.weight", (256, 64), 1) is None


# ---- the 2x2 mesh: tensor and data parallel at once --------------------------
def _early_fused(cfg):
    return dataclasses.replace(cfg, dyhead=dataclasses.replace(cfg.dyhead, early_fuse=True))


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    rcfg = dryrun.tiny_retrieval_config(2)
    jax_run = jax_session(rcfg, 2, 2)
    gcfg = dryrun.tiny_grounding_config(4)
    ranks = dryrun.run_world(workers.tensor_parallel, 4, "cpu",
                             (rcfg, jax_run[0], gcfg, _early_fused(gcfg)),
                             workdir=str(tmp_path_factory.mktemp("world")))
    one = {"grounding": dryrun.grounding_leg(gcfg, None, device="cpu", steps=2),
           "early_fused": dryrun.grounding_leg(_early_fused(gcfg), None, device="cpu",
                                               steps=1)}
    return ranks, jax_run, one


def test_tp_retrieval_session_matches_jax_2x2(tp_world):
    ranks, jax_run, _ = tp_world
    for out in ranks:
        hold_session(out["retrieval"], jax_run, rel=2e-4)
        layout = out["retrieval"]["layout"]
        assert layout and all("mlp_c_fc" in n or "mlp_c_proj" in n for n in layout)


@pytest.mark.parametrize("kind", ["grounding", "early_fused"])
def test_tp_grounding_steps_match_one_process(tp_world, kind):
    ranks, _, one = tp_world
    for out in ranks:
        g = out[kind]
        for mine, ref in zip(g["metrics"], one[kind]["metrics"], strict=True):
            for k, v in ref.items():
                assert mine[k] == pytest.approx(v, rel=1e-4, abs=1e-7), k
        for name, p in g["pools"].items():
            leaf_close(p, one[kind]["pools"][name], name)
