"""`lpi_tpu_torch.losses.clip_loss.global_clip_loss` on 4 gloo ranks
against the JAX package's `global_clip_loss` under `shard_map` on 4 of its
virtual CPU devices: the loss, and the gradients with respect to both
towers' features, within 1e-4.

Each rank differentiates its own share (DDP's convention): the gradient
that reaches rank r's rows is that of the sum of the 4 ranks' losses, so 4
times the global mean's, which JAX differentiates; the learners then
average the pool gradients over the ranks."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from lpi_tpu.losses.clip_loss import global_clip_loss as j_global_clip_loss
from lpi_tpu_torch.dryrun import run_world
from lpi_tpu_torch.losses.clip_loss import clip_loss, global_clip_loss
from tests import torch_dist_workers as workers

torch.set_num_threads(1)
N, B, D, SCALE = 4, 16, 8, 14.0


def _features(seed):
    rng = np.random.RandomState(seed)
    f = rng.randn(2, B, D).astype(np.float32)
    return tuple(x / np.linalg.norm(x, axis=-1, keepdims=True) for x in f)


def _jax(img, txt):
    mesh = Mesh(np.asarray(jax.devices()[:N]), ("data",))
    fn = shard_map(partial(j_global_clip_loss, axis_name="data"), mesh=mesh,
                   in_specs=(P("data"), P("data"), P()), out_specs=P(), check_rep=False)
    loss, grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1)))(
        jnp.asarray(img), jnp.asarray(txt), jnp.float32(SCALE))
    return float(loss), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("seed", [0, 1])
def test_global_loss_and_feature_gradients_match_jax_shard_map(seed, tmp_path):
    img, txt = _features(seed)
    ranks = run_world(workers.global_loss, N, "cpu", (img, txt, SCALE), workdir=str(tmp_path))
    loss, (g_img, g_txt) = _jax(img, txt)
    for out in ranks:
        assert out["loss"] == pytest.approx(loss, rel=1e-4)
    for ours, theirs in ((np.concatenate([r["img_grad"] for r in ranks]), g_img),
                         (np.concatenate([r["txt_grad"] for r in ranks]), g_txt)):
        np.testing.assert_allclose(ours / N, theirs, rtol=1e-4, atol=1e-6)


def test_without_a_group_it_is_the_dense_loss():
    img, txt = (torch.from_numpy(f) for f in _features(2))
    scale = torch.tensor(SCALE)
    assert torch.equal(global_clip_loss(img, txt, scale), clip_loss(scale * img @ txt.T))
    loss, _ = _jax(*_features(2))
    assert float(global_clip_loss(img, txt, scale)) == pytest.approx(loss, rel=1e-5)
