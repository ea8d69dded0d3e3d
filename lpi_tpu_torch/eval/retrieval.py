"""Retrieval metrics: per-task R@k and continual-learning aggregates
(counterpart of `lpi_tpu/eval/retrieval.py`).

Two ranking paths give the same R@k:

* `device_ranks`: the score product and the ranks in torch on the
  features' device, exact fp32 (TF32 off); two [N] rank vectors come back
  to the host. rank(target) = #{j : score[j] > score[target]}, which equals
  the stable argsort position for distinct scores; image-to-text takes the
  smallest rank over an image's ground-truth texts.
* `_ranks_i2t` / `_ranks_t2i`: the host numpy argsort path, the golden
  reference.

`itm_eval` turns ranks into per-task R@1/5/10 both ways with the averaged
summary; `aggregate_results` gives a run's final average and forgetting
(the best earlier precision of a task minus its final one, averaged over
all tasks but the last).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from lpi_tpu_torch.continual.keys import exact_fp32


def _ranks_i2t(scores_i2t: np.ndarray, img2txt: Mapping[int, Sequence[int]]) -> np.ndarray:
    """Rank of the best-ranked ground-truth text per image."""
    order = np.argsort(-scores_i2t, axis=1)
    n_img = scores_i2t.shape[0]
    ranks = np.zeros(n_img)
    pos = np.empty(scores_i2t.shape[1], np.int64)
    for i in range(n_img):
        pos[order[i]] = np.arange(scores_i2t.shape[1])
        ranks[i] = min(pos[t] for t in img2txt[i])
    return ranks


def _ranks_t2i(scores_t2i: np.ndarray, txt2img: Mapping[int, int]) -> np.ndarray:
    order = np.argsort(-scores_t2i, axis=1)
    n_txt = scores_t2i.shape[0]
    ranks = np.zeros(n_txt)
    for i in range(n_txt):
        ranks[i] = np.where(order[i] == txt2img[i])[0][0]
    return ranks


def device_ranks(img_feats, txt_feats, txt2img: Mapping[int, int],
                 img2txt: Mapping[int, Sequence[int]]) -> Tuple[np.ndarray, np.ndarray]:
    """(ranks_i2t [Ni], ranks_t2i [Nt]) as numpy, from features (tensors on
    any device, or arrays) ranked where they lie: scores = img @ txt^T in
    exact fp32, then the ground truths' ranks both ways."""
    img = torch.as_tensor(img_feats).float()
    txt = torch.as_tensor(txt_feats).float().to(img.device)
    n_img, n_txt = img.shape[0], txt.shape[0]
    t2i_idx = torch.tensor([int(txt2img[t]) for t in range(n_txt)], device=img.device)
    kmax = max(len(img2txt[i]) for i in range(n_img))
    i2t_idx = np.zeros((n_img, kmax), np.int64)
    i2t_valid = np.zeros((n_img, kmax), bool)
    for i in range(n_img):
        gts = list(img2txt[i])
        i2t_idx[i, :len(gts)] = gts
        i2t_valid[i, :len(gts)] = True
    i2t_idx = torch.from_numpy(i2t_idx).to(img.device)
    i2t_valid = torch.from_numpy(i2t_valid).to(img.device)
    with torch.no_grad(), exact_fp32():
        scores = img @ txt.T  # [Ni, Nt]
        s_t2i = scores.T
        tgt = s_t2i.gather(1, t2i_idx[:, None])
        ranks_t2i = (s_t2i > tgt).sum(1)
        best = torch.full((n_img,), n_txt, dtype=torch.long, device=img.device)
        for k in range(kmax):  # K is small: K passes over [Ni, Nt]
            r_k = (scores > scores.gather(1, i2t_idx[:, k:k + 1])).sum(1)
            best = torch.where(i2t_valid[:, k], torch.minimum(best, r_k), best)
    return best.cpu().numpy(), ranks_t2i.cpu().numpy()


def _per_task_rk(ranks: np.ndarray, categories: np.ndarray,
                 num_tasks: int) -> Dict[int, List[float]]:
    res = {}
    for task in range(num_tasks):
        r = ranks[categories == task]
        if len(r) == 0:
            res[task] = [0.0, 0.0, 0.0]
            continue
        res[task] = [100.0 * np.mean(r < k) for k in (1, 5, 10)]
    return res


def itm_eval(
    scores_i2t,
    scores_t2i,
    txt2img: Mapping[int, int],
    img2txt: Mapping[int, Sequence[int]],
    img_categories: Sequence[int],
    txt_categories: Sequence[int],
    num_tasks: int,
    ranks: Tuple[np.ndarray, np.ndarray] | None = None,
) -> dict:
    """Per-task R@1/5/10 both directions over the cumulative eval set:
    {'i2t': {task: [r1, r5, r10]}, 't2i': {...}, 'summary': averages}. Pass
    `ranks` (from `device_ranks`) to skip the host score matrices; then
    scores_* may be None."""
    img_cat = np.asarray(img_categories)
    txt_cat = np.asarray(txt_categories)
    if ranks is not None:
        r_i2t, r_t2i = ranks
    else:
        r_i2t = _ranks_i2t(scores_i2t, img2txt)
        r_t2i = _ranks_t2i(scores_t2i, txt2img)
    i2t = _per_task_rk(np.asarray(r_i2t), img_cat, num_tasks)
    t2i = _per_task_rk(np.asarray(r_t2i), txt_cat, num_tasks)

    def avg(res):
        return np.array([res[t] for t in range(num_tasks)]).mean(axis=0)

    tr1, tr5, tr10 = avg(i2t)
    ir1, ir5, ir10 = avg(t2i)
    summary = {
        "txt_r1": tr1, "txt_r5": tr5, "txt_r10": tr10,
        "txt_r_mean": (tr1 + tr5 + tr10) / 3,
        "img_r1": ir1, "img_r5": ir5, "img_r10": ir10,
        "img_r_mean": (ir1 + ir5 + ir10) / 3,
    }
    summary["r_mean"] = (summary["txt_r_mean"] + summary["img_r_mean"]) / 2
    return {"i2t": i2t, "t2i": t2i, "summary": summary}


def aggregate_results(
    sessions: Mapping[int, dict],
    direction: str = "i2t",
    k_index: int = 0,
    weights: Sequence[float] | None = None,
) -> dict:
    """Continual aggregates over the session results:

    * `average`: weighted mean over tasks of the final session's per-task
      precision (uniform weights by default),
    * `forgetting`: mean over tasks (but the last) of the best precision of
      an earlier session minus the final session's.
    """
    num_sessions = len(sessions)
    last = sessions[num_sessions - 1][direction]
    final = np.array([last[t][k_index] for t in range(num_sessions)])
    w = np.ones(num_sessions) if weights is None else np.asarray(
        weights, dtype=float)[:num_sessions]
    average = float((final * w).sum() / w.sum())

    forgetting = 0.0
    count = 0
    for t in range(num_sessions - 1):
        best_prev = max(
            sessions[s][direction][t][k_index] for s in range(t, num_sessions - 1)
        )
        forgetting += best_prev - final[t]
        count += 1
    forgetting = float(forgetting / max(count, 1))
    return {"average": average, "forgetting": forgetting}
