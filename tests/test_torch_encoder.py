"""The port's Swin block, BERT layer and fused dual encoder against the JAX
package, with the Flax weights carried over by `lpi_tpu_torch.bridge`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lpi_tpu.core import config as jc
from lpi_tpu.models.glip.bert import BertLayer as JBertLayer
from lpi_tpu.models.glip.fused import FusedDualEncoder as JFused
from lpi_tpu.models.glip.swin import SwinBlock as JSwinBlock
from lpi_tpu_torch import config as tc
from lpi_tpu_torch.bridge import params_from_jax
from lpi_tpu_torch.models.glip.bert import BertLayer
from lpi_tpu_torch.models.glip.fused import FusedDualEncoder
from lpi_tpu_torch.models.glip.swin import SwinBlock
from tests.test_composed_parity import _assert_close

torch.set_num_threads(1)


def _load(module, flax_params, **kw):
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, flax_params), **kw),
                           strict=True)
    return module.eval()


@pytest.mark.parametrize("shift,H,W", [(0, 8, 8), (2, 8, 12), (2, 10, 6)])
def test_swin_block(rng, shift, H, W):
    C, heads, ws = 16, 2, 4
    x = rng.randn(2, H * W, C).astype(np.float32)
    jb = JSwinBlock(dim=C, num_heads=heads, window_size=ws, shift=shift)
    params = jb.init(jax.random.PRNGKey(0), jnp.asarray(x), H, W)["params"]
    want = np.asarray(jb.apply({"params": params}, jnp.asarray(x), H, W))
    tb = _load(SwinBlock(C, heads, ws, shift=shift), params)
    with torch.no_grad():
        got = tb(torch.from_numpy(x), H, W).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_bert_layer(rng):
    kw = dict(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
              intermediate_size=32, max_position_embeddings=32)
    x = rng.randn(2, 10, 16).astype(np.float32)
    mask = np.ones((2, 10), np.float32)
    mask[1, 6:] = 0
    jl = JBertLayer(jc.BertConfig(**kw))
    params = jl.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))["params"]
    want = np.asarray(jl.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask)))
    tl = _load(BertLayer(tc.BertConfig(**kw)), params)
    with torch.no_grad():
        got = tl(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


# All four stage widths carry an active corner: P*pv/C = 8, 4, 2, 1.
SWIN = dict(patch_size=4, embed_dim=8, depths=(2, 2, 6, 2), num_heads=(1, 2, 2, 2),
            window_size=4)
BERT = dict(vocab_size=64, hidden_size=16, num_layers=12, num_heads=2,
            intermediate_size=32, max_position_embeddings=32, max_query_len=20)


@pytest.mark.parametrize("interact_type,prompt_depth,interact_depth,pooled", [
    ("linear", 9, 9, 1),  # the LPI paper's shape
    ("maple", 2, 5, 3),  # replace-mode injection, depths crossing stages, 3 pooled
])
def test_fused_dual_encoder(rng, interact_type, prompt_depth, interact_depth, pooled):
    lpi_kw = dict(prompt_length=8, prompt_depth=prompt_depth, prompt_rank=2,
                  interact_rank=2, interact_depth=interact_depth,
                  interact_type=interact_type)
    B, S = 2, 20
    images = rng.randn(B, 32, 48, 3).astype(np.float32)
    ids = rng.randint(1, 64, size=(B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[1, 14:] = 0.0
    visp = (0.1 * rng.randn(B, 12, 8, 8)).astype(np.float32)  # per-sample prompts
    txtp = (0.1 * rng.randn(B, 12, 8, 16)).astype(np.float32)
    task_id = 1

    je = JFused(swin_cfg=jc.SwinConfig(**SWIN), bert_cfg=jc.BertConfig(**BERT),
                lpi_cfg=jc.LPIPromptConfig(**lpi_kw), num_tasks=3)  # scanned pairs
    args = [jnp.asarray(a) for a in (images, ids, mask, visp, txtp)]
    params = jax.jit(je.init, static_argnums=6)(jax.random.PRNGKey(0), *args, task_id)["params"]
    jlang, jouts = jax.jit(lambda p, *a: je.apply({"params": p}, *a, task_id,
                                                  num_pooled_layers=pooled))(params, *args)
    te = FusedDualEncoder(tc.SwinConfig(**SWIN), tc.BertConfig(**BERT),
                          tc.LPIPromptConfig(**lpi_kw), num_tasks=3)
    state = params_from_jax({"encoder": jax.tree.map(np.asarray, params)},
                            depths=SWIN["depths"])
    te.load_state_dict({k[len("encoder."):]: v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        tlang, touts = te.eval()(*[torch.from_numpy(a) for a in (images, ids, mask, visp, txtp)],
                                 task_id=task_id, num_pooled_layers=pooled)
        # no prompts: the schedule reduces to the plain towers
        plain_lang, _ = te(*[torch.from_numpy(a) for a in (images, ids, mask)])
    assert len(touts) == len(jouts) == 4
    for ours, theirs in zip(touts, jouts):
        _assert_close(ours.numpy(), theirs)
    for key in ("aggregate", "embedded", "hidden"):
        _assert_close(tlang[key].numpy(), jlang[key])
    assert not np.allclose(plain_lang["hidden"].numpy(), tlang["hidden"].numpy())
