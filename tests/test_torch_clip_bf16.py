"""The tiny SliNet in bf16: the port against the JAX package.

`tests/test_torch_clip.py`'s config and inputs with `dtype="bfloat16"` in
both packages (parameters fp32, compute bf16, LayerNorms and the softmax in
fp32), weights carried by `bridge.slinet_params_from_jax`. The two packages
round in different places (XLA on the CPU against PyTorch's CPU kernels),
so the bar is a count of bf16 steps (2^-8), relative Frobenius:

* features: 4 steps. A feature passes about 20 roundings to bf16 of its
  residual stream (3 blocks of LayerNorm casts, products and residual
  adds, then the projection), each within half a step and mostly
  uncorrelated: about sqrt(20) / 2 < 4 steps.
* the pool gradient: 8 steps. The backward runs the forward's roundings
  again and rounds each of its own products' results to bf16 (about twice
  the forward's count), and the softmax at a logit scale of 100 multiplies
  the features' error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lpi_tpu.losses import alignment_loss as j_align
from lpi_tpu.losses import clip_loss as j_clip
from lpi_tpu_torch.losses.clip_loss import alignment_loss, clip_loss
from tests.test_torch_clip import TASK, _inputs, _pair

torch.set_num_threads(1)
STEP = 2.0 ** -8
FEATURE_BAR, GRADIENT_BAR = 4 * STEP, 8 * STEP


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_bf16_features_and_pool_gradient_agree_with_jax():
    """The tiny SliNet with `dtype="bfloat16"` in both packages from carried
    weights: both features, and the task-2 slice of the gradient of the
    pools (a contrastive loss over the features plus the alignment loss),
    within `FEATURE_BAR` and `GRADIENT_BAR` relative Frobenius."""
    jm, params, tm = _pair("bfloat16")
    images, ids = _inputs()
    pools = {k: params[k] for k in ("prompts", "ctx_pool")}
    frozen = {k: v for k, v in params.items() if k not in pools}

    def jloss(pools):
        img, txt, vp, tp, scale = jm.apply({"params": {**frozen, **pools}},
                                           jnp.asarray(images), jnp.asarray(ids), TASK)
        return j_clip(scale * img @ txt.T) + 0.1 * j_align(vp, tp), (img, txt)

    (_, (jimg, jtxt)), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(pools)
    img, txt, vp, tp, scale = tm(torch.from_numpy(images), torch.from_numpy(ids).long(),
                                 torch.tensor(TASK))
    loss = clip_loss(scale * img @ txt.T) + 0.1 * alignment_loss(vp, tp)
    names = [n for n, _ in tm.prompts.named_parameters()]
    grads = torch.autograd.grad(loss, [getattr(tm.prompts, n) for n in names])
    feats = {"image": _rel(img.detach().numpy(), jimg), "text": _rel(txt.detach().numpy(), jtxt)}
    got = np.concatenate([g[TASK].numpy().ravel() for g in grads])
    want = np.concatenate([np.asarray(jgrads["prompts"][n][TASK]).ravel() for n in names])
    grad = _rel(got, want)
    print(f"bf16 relative Frobenius errors: features {feats}, pool gradient {grad}")
    assert all(e <= FEATURE_BAR for e in feats.values()), (feats, FEATURE_BAR)
    assert grad <= GRADIENT_BAR, (grad, GRADIENT_BAR)
