"""One grounding request, worked out plainly for the benchmark's reference,
from the same image and caption the program was given (frozen from the
port's `serve/predictor.py`, `data/transforms.py`, `data/bert_tokenizer.py`,
`continual/keys.py` and `models/glip/postprocess.py`, with a greedy NMS of
its own):

* the image resized to (S, S) ignoring aspect (PIL bilinear on uint8) and
  normalised as BGR x 255 minus the pixel mean over the pixel std;
* the caption's entities by the rule-based chunker (split at verbs and
  prepositions, leading articles stripped), its tokens by the hashed
  WordPiece fallback (whole words hashed into the id range), the entity's
  tokens those whose character ranges overlap it;
* the task: the one whose nearest key centre is nearest in L1 to the
  promptless P7 feature;
* the prompted forward with that task's prompts, then per level the
  scores sqrt-free as the port has them (mean token probability x
  sigmoid(centerness)), top `pre_nms_top_n` above the threshold, decoded
  and clipped, class-aware greedy NMS, the top `post_nms_top_n`, boxes
  mapped back to the image's own coordinates.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.reference.boxes import box_iou, decode_boxes

PIXEL_MEAN = np.asarray([103.530, 116.280, 123.675], np.float32)
PIXEL_STD = np.asarray([57.375, 57.120, 58.395], np.float32)
CLS_ID, SEP_ID, PAD_ID = 101, 102, 0

_STOP_SPLITTERS = {
    "is", "are", "was", "were", "be", "being", "been", "am",
    "on", "in", "at", "of", "over", "under", "above", "below", "near",
    "next", "to", "with", "without", "behind", "beside", "between",
    "by", "from", "into", "through", "during", "against", "among",
    "and", "or", "that", "which", "who", "while", "holding", "wearing",
    "standing", "sitting", "walking", "running", "looking", "chasing",
    "eating", "playing", "riding", "jumping", "flying", "driving",
    "carrying", "watching", "hanging", "lying", "leaning",
}
_ARTICLES = {"a", "an", "the", "this", "that", "these", "those", "its",
             "his", "her", "their", "my", "your", "our", "some", "another"}


def prepare_image(image: np.ndarray, size: int) -> Tuple[np.ndarray, Tuple[float, float]]:
    """uint8 RGB [H, W, 3] -> ([1, S, S, 3] network input, (sx, sy))."""
    from PIL import Image

    H0, W0 = image.shape[:2]
    arr = np.asarray(image, np.float32) / 255.0
    u8 = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    resized = np.asarray(Image.fromarray(u8).resize((size, size), Image.BILINEAR),
                         np.float32) / 255.0
    bgr = resized[..., ::-1] * 255.0
    return ((bgr - PIXEL_MEAN) / PIXEL_STD).astype(np.float32)[None], (size / W0, size / H0)


def entities(caption: str) -> Tuple[List[List[Tuple[int, int]]], List[str]]:
    """The caption's entities: their character spans and their text."""
    words = re.findall(r"[a-zA-Z0-9']+", caption.lower())
    phrases, cur = [], []
    for w in words:
        if w in _STOP_SPLITTERS:
            if cur:
                phrases.append(cur)
                cur = []
        else:
            cur.append(w)
    if cur:
        phrases.append(cur)
    spans, names = [], []
    for p in phrases:
        while p and p[0] in _ARTICLES:
            p = p[1:]
        phrase = re.sub(r"[^\w\s]", "", " ".join(p)).strip()
        if not phrase:
            continue
        found = [(m.start(), m.end()) for m in re.finditer(re.escape(phrase), caption.lower())]
        if found:
            spans.append(found)
            names.append(phrase)
    return spans, names


def _punct(ch: str) -> bool:
    cp = ord(ch)
    return ((33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126)
            or unicodedata.category(ch).startswith("P"))


def tokenize(text: str, max_len: int, vocab_size: int):
    """-> (ids [1, max_len], mask [1, max_len], character range per token)."""
    words, cur, start = [], [], 0
    for i, ch in enumerate(text):
        if ch.isspace() or _punct(ch):
            if cur:
                words.append(("".join(cur), start, i))
                cur = []
            if _punct(ch):
                words.append((ch, i, i + 1))
        else:
            if not cur:
                start = i
            cur.append(ch.lower())
    if cur:
        words.append(("".join(cur), start, len(text)))
    base = 1000 if vocab_size > 2000 else 110
    ids, ranges = [CLS_ID], [(0, 0)]
    for word, s, e in words:
        h = 2166136261
        for b in word.encode("utf-8"):
            h = ((h ^ b) * 16777619) & 0xFFFFFFFF
        ids.append(base + h % (vocab_size - base))
        ranges.append((s, max(e, s + 1)))
    ids.append(SEP_ID)
    ranges.append((0, 0))
    if len(ids) > max_len:
        ids, ranges = ids[:max_len - 1] + [SEP_ID], ranges[:max_len - 1] + [(0, 0)]
    out = np.full((1, max_len), PAD_ID, np.int64)
    out[0, :len(ids)] = ids
    mask = np.zeros((1, max_len), np.float32)
    mask[0, :len(ids)] = 1.0
    return out, mask, ranges


def token_map(spans, ranges, max_len: int) -> np.ndarray:
    """[entities, max_len]: 1 where a token's range overlaps the entity."""
    out = np.zeros((len(spans), max_len), np.float32)
    for j, sp in enumerate(spans):
        for beg, end in sp:
            for t, (cs, ce) in enumerate(ranges):
                if t < max_len and ce > cs and cs < end and beg < ce:
                    out[j, t] = 1.0
    return out


def task_distances(features: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """features [D], centres [T, k, D] -> per task the L1 distance to its
    nearest centre [T]."""
    return (features.double()[None, None] - centers.double()).abs().sum(-1).min(-1).values


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor,
               thresh: float) -> torch.Tensor:
    """Keep mask: in score order, a box is kept unless a kept box of its label
    overlaps it by IoU > thresh."""
    order = torch.argsort(-scores, stable=True).cpu().numpy()
    over = (box_iou(boxes, boxes) > thresh).cpu().numpy()
    lab = labels.cpu().numpy()
    out = ~torch.isfinite(scores).cpu().numpy()
    keep = np.zeros(len(order), bool)
    for i in order:
        if not out[i]:
            keep[i] = True
            out |= over[i] & (lab == lab[i])
    return torch.from_numpy(keep).to(scores.device)


def detections(flat: Dict[str, torch.Tensor], tmap: torch.Tensor, size: int,
               pre_nms_thresh: float, pre_nms_top_n: int, post_nms_top_n: int,
               nms_thresh: float) -> Dict[str, torch.Tensor]:
    """The first image's detections, and the candidates before NMS
    (`cand_boxes`, `cand_scores`), in the resized image's coordinates."""
    anchors, counts = flat["anchors"], tuple(int(c) for c in flat["level_counts"])
    C = tmap.shape[0]
    ctr = torch.sigmoid(flat["centerness"][0].float())
    probs = torch.sigmoid(flat["dot_logits"][0].float())
    scores = probs @ tmap.T / torch.clamp(tmap.sum(-1), min=1.0)[None] * ctr[:, None]
    boxes, top_s, labels, start = [], [], [], 0
    for n in counts:
        s = scores[start:start + n]
        s = torch.where(s > pre_nms_thresh * ctr[start:start + n, None], s,
                        torch.full_like(s, -float("inf")))
        top, idx = torch.topk(s.reshape(-1), min(pre_nms_top_n, n * C))
        loc = idx // C + start
        boxes.append(decode_boxes(flat["bbox_pred"][0].float()[loc], anchors[loc]))
        top_s.append(top)
        labels.append(idx % C + 1)
        start += n
    boxes, top_s, labels = torch.cat(boxes).clamp(0, size), torch.cat(top_s), torch.cat(labels)
    keep = greedy_nms(boxes, top_s, labels, nms_thresh)
    kept = torch.where(keep, top_s, torch.full_like(top_s, -float("inf")))
    top, idx = torch.topk(kept, min(post_nms_top_n, kept.shape[0]))
    valid = torch.isfinite(top)
    ok = torch.isfinite(top_s)
    return {"boxes": boxes[idx][valid], "scores": top[valid], "labels": labels[idx][valid],
            "cand_boxes": boxes[ok], "cand_scores": top_s[ok]}
