"""Contrastive losses of the LPI mechanism (counterpart of
`lpi_tpu/losses/clip_loss.py`, the parts the train steps use).

* `clip_loss`: symmetric cross-entropy over a square logits matrix with
  diagonal positives.
* `nt_bxent_loss_masked`: the multi-positive sigmoid contrastive loss over
  the rows and columns marked valid, with the reference's double sigmoid
  (the cosine matrix over the temperature is sigmoided, then fed to
  BCE-with-logits) and the diagonal forced to +inf before the first sigmoid.
* `task_prompt_loss_masked`: the inter-task loss over the flattened prompt
  stacks of tasks 0..task_id; 0 at task 0.
* `alignment_loss`: the retrieval cross-modal prompt alignment, a symmetric
  InfoNCE over the layer-by-layer matrix of channel-mean prompts.
"""

from __future__ import annotations

import torch

from lpi_tpu_torch.ops.clip import clip


def _softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy with integer labels, fp32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[:, None])[:, 0]
    return (logz - picked).mean()


def clip_loss(logits: torch.Tensor) -> torch.Tensor:
    """Symmetric CE over a square similarity matrix, diagonal positives."""
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (_softmax_xent(logits, labels) + _softmax_xent(logits.T, labels))


def _bce_with_logits(z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Elementwise BCEWithLogits: max(z, 0) - z*t + log1p(exp(-|z|))."""
    return clip(z, 0.0) - z * t + torch.log1p(torch.exp(-z.abs()))


def nt_bxent_loss_masked(x: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
                         temperature: float = 1.0) -> torch.Tensor:
    """Multi-positive sigmoid contrastive loss over the `valid` rows and
    columns of x [n, d] with the binary relation `target` [n, n]."""
    x = x.float()
    target = target.float()
    n = x.shape[0]
    valid = valid.bool()
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    # torch cosine_similarity's eps on the norms
    xn = x / clip(norm, 1e-8)
    xcs = xn @ xn.T
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    xcs = torch.where(eye, torch.full_like(xcs, float("inf")), xcs)

    z = torch.sigmoid(xcs / temperature)  # the reference's double-sigmoid input
    loss = _bce_with_logits(z, target)

    vcol = valid[None, :]
    pos = (target > 0) & vcol
    neg = (target <= 0) & vcol
    zero = torch.zeros_like(loss)
    loss_pos = torch.where(pos, loss, zero).sum(1)
    loss_neg = torch.where(neg, loss, zero).sum(1)
    num_pos = torch.where(vcol, target, torch.zeros_like(target)).sum(1)
    num_neg = neg.sum(1).float()
    row = loss_pos / clip(num_pos, 1.0) + loss_neg / clip(num_neg, 1.0)
    return torch.where(valid, row, torch.zeros_like(row)).sum() / torch.clamp(
        valid.sum(), min=1)


def task_prompt_loss_masked(visual_stack: torch.Tensor, textual_stack: torch.Tensor,
                            task_relation: torch.Tensor, task_id,
                            temperature: float = 0.001) -> torch.Tensor:
    """Inter-task loss over the prompt stacks [T, L*P*D] of tasks
    0..task_id: the mean of the visual and textual `nt_bxent_loss_masked`
    terms; exactly 0 at task 0. `task_id` is an int or a 0-d integer tensor
    on the stacks' device."""
    n = visual_stack.shape[0]
    valid = torch.arange(n, device=visual_stack.device) <= task_id
    loss = 0.5 * (nt_bxent_loss_masked(visual_stack, task_relation, valid, temperature)
                  + nt_bxent_loss_masked(textual_stack, task_relation, valid, temperature))
    live = torch.as_tensor(task_id >= 1, device=loss.device)
    return torch.where(live, loss, torch.zeros_like(loss))


def alignment_loss(visual_prompt: torch.Tensor, textual_prompt: torch.Tensor,
                   temperature: float = 0.01) -> torch.Tensor:
    """Cross-modal prompt alignment in fp32: prompts [L, P, D] are averaged
    over channels to [L, P] and divided by the temperature; the [L, L]
    layer-by-layer matrix gets `clip_loss`. Unweighted: callers apply the
    0.1."""
    v = visual_prompt.float().mean(-1) / temperature
    t = textual_prompt.float().mean(-1) / temperature
    return clip_loss(v @ t.T)
