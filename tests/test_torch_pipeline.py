"""`lpi_tpu_torch.core.pipeline` against `lpi_tpu.core.pipeline`: an
8-block CLIP tower with per-layer, per-sample prompts (layer 0's gate
off), the JAX package's weights, run as 4 stages x 4 microbatches on 4
gloo ranks, and as 2 data x 2 stages (dp x pp) on 4 ranks. The output and
the gradients of mean(out^2) with respect to every stage's block
parameters and prompts are held to JAX's `pipeline_tower` on 4 virtual
devices within 1e-4, and the output to JAX's sequential scan."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from lpi_tpu.core.pipeline import pipeline_tower
from lpi_tpu.models.clip.model import PromptedBlock
from lpi_tpu_torch import dryrun
from lpi_tpu_torch.bridge import slinet_params_from_jax

torch.set_num_threads(1)
L, W, H, S_TOK, P_TOK, B, STAGES, MICRO = 8, 32, 2, 6, 2, 8, 4, 4
PREFIX = "clip.visual.transformer."


def _port_names(tree) -> dict:
    """A scanned tower's params (or their gradients) -> {"{l}.{name}": array}."""
    state = slinet_params_from_jax({"clip": {"visual": {"transformer": jax.tree.map(
        np.asarray, tree)}}})
    return {k[len(PREFIX):]: v.numpy() for k, v in state.items()}


@pytest.fixture(scope="module")
def reference():
    tower = nn.scan(PromptedBlock, variable_axes={"params": 0}, split_rngs={"params": True},
                    length=L, in_axes=0)(width=W, heads=H, causal=False, dtype=jnp.float32,
                                         attn_impl="xla")
    rng = np.random.RandomState(0)
    x = rng.randn(B, S_TOK, W).astype(np.float32)
    prompts = (rng.randn(L, B, P_TOK, W) * 0.1).astype(np.float32)
    gates = np.ones(L, np.float32)
    gates[0] = 0.0
    jg = jnp.asarray(gates).reshape(L, 1, 1, 1)
    params = tower.init(jax.random.PRNGKey(0), x, (prompts, jg))["params"]
    seq, _ = tower.apply({"params": params}, x, (prompts, jg))
    mesh = Mesh(np.asarray(jax.devices()[:STAGES]), ("pipe",))

    def loss(p, pr):
        out = pipeline_tower(mesh, "pipe", p, x, pr, jg, width=W, heads=H, dtype=jnp.float32,
                             microbatches=MICRO)
        return jnp.mean(out ** 2), out

    (val, out), (gp, gpr) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(prompts))
    return dict(params=_port_names(params), x=x, prompts=prompts, gates=gates,
                seq=np.asarray(seq), out=np.asarray(out), loss=float(val),
                grads=_port_names(gp), prompt_grads=np.asarray(gpr))


@pytest.mark.parametrize("dp,stages", [(1, STAGES), (2, 2)], ids=["pp", "dp_x_pp"])
def test_pipeline_matches_jax_forward_and_gradients(reference, dp, stages, tmp_path):
    ref = reference
    ranks = dryrun.run_world(dryrun.pipeline_leg, 4, "cpu",
                             (ref["params"], ref["x"], ref["prompts"], ref["gates"], W, H,
                              stages, MICRO, dp), workdir=str(tmp_path))
    seen = set()
    for out in ranks:
        np.testing.assert_allclose(out["out"], ref["out"], rtol=1e-4, atol=1e-5)
        assert np.abs(out["out"] - ref["seq"]).max() < 1e-4
        assert out["loss"] == pytest.approx(ref["loss"], rel=1e-5)
        for name, g in out["grads"].items():
            want = (ref["prompt_grads"][out["layers"]] if name == "prompts"
                    else ref["grads"][name])
            np.testing.assert_allclose(g, want, rtol=1e-4, atol=1e-6, err_msg=name)
        seen |= set(out["grads"]) - {"prompts"}
    assert seen == set(ref["grads"])  # every layer's every parameter, by its stage

