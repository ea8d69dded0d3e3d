"""Contrastive losses of the LPI mechanism (counterpart of
`lpi_tpu/losses/clip_loss.py`).

* `clip_loss`: symmetric cross-entropy over a square logits matrix with
  diagonal positives.
* `global_clip_loss`: the batch-global InfoNCE with the features sharded
  over a `data` group: each rank's rows against every rank's rows of the
  other tower, labels offset by the rank, the mean over the ranks (the
  reference's dormant `local_loss`, which the JAX package runs under
  `shard_map`).
* `nt_bxent_loss`: the multi-positive sigmoid contrastive loss over row
  vectors, with the reference's double sigmoid (the cosine matrix over the
  temperature is sigmoided, then fed to BCE-with-logits) and the diagonal
  forced to +inf before the first sigmoid; `nt_bxent_loss_masked`, the
  same over the rows and columns marked valid.
* `task_prompt_loss`: the inter-task loss over the flattened prompt stacks
  of the tasks seen so far; `task_prompt_loss_masked`, over tasks
  0..task_id of the whole stacks (what the train steps use), 0 at task 0.
* `alignment_loss`: the retrieval cross-modal prompt alignment, a symmetric
  InfoNCE over the layer-by-layer matrix of channel-mean prompts.
* `info_nce`: unit-normalised InfoNCE with in-batch negatives.

The unmasked forms have no caller in either package; they are library API.
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


def global_clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                     logit_scale: torch.Tensor, group=None) -> torch.Tensor:
    """Batch-global InfoNCE over features [local_b, d] sharded over
    `group`: both towers' features gathered (`core.dist.gather_rows`),
    logits [local_b, global_b] each way, labels `rank * local_b + i`, this
    rank's loss the mean over its rows. The value returned is the mean over
    the ranks, the global batch's loss; its gradient is this rank's own
    loss's (`core.dist.global_mean`), so that the pool gradients averaged
    over `group` are the global loss's. With `group=None`, `clip_loss`
    over the whole matrix."""
    if group is None:
        return clip_loss(logit_scale * image_features @ text_features.T)
    import torch.distributed as dist

    from lpi_tpu_torch.core.dist import gather_rows, global_mean

    local_b = image_features.shape[0]
    all_text = gather_rows(text_features, group)
    all_image = gather_rows(image_features, group)
    labels = torch.arange(local_b, device=image_features.device) + dist.get_rank(group) * local_b
    loss = 0.5 * (_softmax_xent(logit_scale * image_features @ all_text.T, labels)
                  + _softmax_xent(logit_scale * text_features @ all_image.T, labels))
    return global_mean(loss, group)


def _bce_with_logits(z: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Elementwise BCEWithLogits: max(z, 0) - z*t + log1p(exp(-|z|))."""
    return clip(z, 0.0) - z * t + torch.log1p(torch.exp(-z.abs()))


def _pair_losses(x: torch.Tensor, target: torch.Tensor, temperature: float) -> torch.Tensor:
    """The elementwise loss [n, n] of the sigmoid contrastive loss, in fp32:
    row cosines (norms clipped at torch cosine_similarity's eps 1e-8), the
    diagonal at +inf, over the temperature, sigmoided, then BCE-with-logits
    against `target`."""
    x = x.float()
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    xn = x / clip(norm, 1e-8)
    xcs = xn @ xn.T
    eye = torch.eye(x.shape[0], dtype=torch.bool, device=x.device)
    xcs = torch.where(eye, torch.full_like(xcs, float("inf")), xcs)
    z = torch.sigmoid(xcs / temperature)  # the reference's double-sigmoid input
    return _bce_with_logits(z, target.float())


def nt_bxent_loss(x: torch.Tensor, target: torch.Tensor,
                  temperature: float = 1.0) -> torch.Tensor:
    """Multi-positive sigmoid contrastive loss over the rows of x [n, d]
    with the binary relation `target` [n, n]: each row's positive and
    negative sums over their counts, averaged over the rows."""
    loss = _pair_losses(x, target, temperature)
    target = target.float()
    pos = target > 0
    zero = torch.zeros_like(loss)
    loss_pos = torch.where(pos, loss, zero).sum(1)
    loss_neg = torch.where(pos, zero, loss).sum(1)
    num_pos = target.sum(1)
    num_neg = x.shape[0] - num_pos
    return (loss_pos / num_pos + loss_neg / num_neg).mean()


def nt_bxent_loss_masked(x: torch.Tensor, target: torch.Tensor, valid: torch.Tensor,
                         temperature: float = 1.0) -> torch.Tensor:
    """`nt_bxent_loss` over the `valid` rows and columns of x [n, d] with
    the binary relation `target` [n, n], at static shapes."""
    loss = _pair_losses(x, target, temperature)
    target = target.float()
    valid = valid.bool()
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


def task_prompt_loss(visual_stack: torch.Tensor, textual_stack: torch.Tensor,
                     task_relation: torch.Tensor, temperature: float = 0.001) -> torch.Tensor:
    """Inter-task loss over the flattened prompt stacks [T, L*P*D] of every
    task seen so far, with their relation [T, T] (task-name similarity over
    0.4): the mean of the visual and textual `nt_bxent_loss` terms."""
    return 0.5 * (nt_bxent_loss(visual_stack, task_relation, temperature)
                  + nt_bxent_loss(textual_stack, task_relation, temperature))


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


def info_nce(query: torch.Tensor, positive_key: torch.Tensor,
             temperature: float = 0.1) -> torch.Tensor:
    """Unit-normalised InfoNCE with in-batch negatives: row i of `query`
    against every row of `positive_key`, its own the positive."""
    q = query / torch.linalg.vector_norm(query, dim=-1, keepdim=True)
    k = positive_key / torch.linalg.vector_norm(positive_key, dim=-1, keepdim=True)
    logits = q @ k.T / temperature
    labels = torch.arange(q.shape[0], device=q.device)
    return _softmax_xent(logits, labels)
