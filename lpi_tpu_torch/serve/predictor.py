"""Grounding inference predictor and visualisation (counterpart of
`lpi_tpu/serve/predictor.py`).

* `find_noun_phrases` / `run_ner`: rule-based entity extraction into char
  spans (split at verbs / prepositions, strip leading articles).
* `GroundingPredictor.predict(image, caption)`: resize and normalise,
  tokenize, build the positive map, infer the task id from frozen P7
  features with the KMeans keys, run the prompted forward, postprocess, map
  boxes back to the original image's coordinates.
* `draw_predictions`: PIL box and label overlay.

`predict` marks its phases (prepare, task_id, forward, postprocess) as
profiler ranges, which `chip_smoke.py` reads; without a profiler each
costs microseconds against a request of about 100 ms.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from lpi_tpu_torch.continual.keys import TaskKeys, exact_fp32, infer_task_ids
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer, positive_map_from_spans
from lpi_tpu_torch.data.transforms import normalize_bgr255, resize_distort
from lpi_tpu_torch.models.glip.postprocess import atss_postprocess

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


def find_noun_phrases(caption: str) -> List[str]:
    """Heuristic noun-phrase chunker: split at verbs/prepositions, strip
    leading articles, keep non-empty chunks."""
    words = re.findall(r"[a-zA-Z0-9']+", caption.lower())
    phrases: List[List[str]] = []
    cur: List[str] = []
    for w in words:
        if w in _STOP_SPLITTERS:
            if cur:
                phrases.append(cur)
                cur = []
        else:
            cur.append(w)
    if cur:
        phrases.append(cur)
    out = []
    for p in phrases:
        while p and p[0] in _ARTICLES:
            p = p[1:]
        if p:
            out.append(" ".join(p))
    return out


def remove_punctuation(text: str) -> str:
    return re.sub(r"[^\w\s]", "", text).strip()


def run_ner(caption: str) -> Tuple[List[List[Tuple[int, int]]], List[str]]:
    """Entities -> char spans over the caption (all occurrences)."""
    phrases = [remove_punctuation(p) for p in find_noun_phrases(caption)]
    tokens_positive, entities = [], []
    for phrase in (p for p in phrases if p):
        spans = [(m.start(), m.end())
                 for m in re.finditer(re.escape(phrase), caption.lower())]
        if spans:
            tokens_positive.append(spans)
            entities.append(phrase)
    return tokens_positive, entities


class GroundingPredictor:
    """Inference wrapper around a `GroundedVLModel` and its task keys.

    The model and keys are moved to `device` (the card unless the caller
    asks for the CPU). The forward runs with TF32 off, so an fp32 model
    computes in full fp32 as the JAX reference does.
    """

    def __init__(self, model, keys: Optional[TaskKeys] = None, tokenizer=None,
                 image_size: int = 800, score_thresh: float = 0.5,
                 atss_cfg=None, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.keys = keys.to(self.device) if keys is not None else None
        self.tokenizer = tokenizer or BertTokenizer()
        self.image_size = image_size
        self.score_thresh = score_thresh
        self.atss_cfg = atss_cfg

    def _prepare_image(self, image: np.ndarray):
        """Distorting resize to (image_size, image_size) + BGR*255
        normalisation, as in training. Returns the network input [1,S,S,3]
        plus per-axis (sx, sy) scales for mapping boxes back."""
        arr = np.asarray(image)
        if arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] != 3):
            from PIL import Image

            u8 = arr if arr.dtype == np.uint8 else \
                np.clip(np.asarray(arr, np.float32) * (255.0 if arr.dtype.kind == "f" else 1.0),
                        0, 255).astype(np.uint8)
            arr = np.asarray(Image.fromarray(u8).convert("RGB"))
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        else:
            arr = np.asarray(arr, np.float32)
        H0, W0 = arr.shape[:2]
        resized, _ = resize_distort(arr, np.zeros((0, 4)), self.image_size,
                                    self.image_size)
        return normalize_bgr255(resized)[None], (self.image_size / W0,
                                                 self.image_size / H0)

    @torch.no_grad()
    def predict(self, image: np.ndarray, caption: str,
                custom_entity: Optional[str] = None) -> dict:
        """-> dict(boxes [K,4] original coords, scores [K], entities [K],
        task_id)."""
        with record_function("predict.prepare"):
            canvas, (sx, sy) = self._prepare_image(image)
        if custom_entity:
            spans = [[(m.start(), m.end())
                      for m in re.finditer(re.escape(custom_entity.lower()),
                                           caption.lower())]]
            entities = [custom_entity]
        else:
            spans, entities = run_ner(caption)
        if not spans:
            return {"boxes": np.zeros((0, 4)), "scores": np.zeros(0), "entities": []}

        ids, mask, offsets = self.tokenizer([caption])
        label_map = positive_map_from_spans(spans, offsets[0], ids.shape[1])
        dev = self.device
        images = torch.from_numpy(canvas).to(dev)
        with exact_fp32():
            with record_function("predict.task_id"):
                if self.keys is not None:
                    sel = infer_task_ids(self.model.extract_features(images), self.keys)
                else:
                    sel = torch.zeros((1,), dtype=torch.long, device=dev)
            with record_function("predict.forward"):
                flat, _ = self.model.forward_tasks(
                    images, torch.from_numpy(ids).long().to(dev),
                    torch.from_numpy(mask).to(dev), sel)
            kw = {}
            if self.atss_cfg is not None:
                n = flat["anchors"].shape[0]
                kw = dict(pre_nms_top_n=min(self.atss_cfg.pre_nms_top_n, n),
                          post_nms_top_n=min(self.atss_cfg.fpn_post_nms_top_n, n),
                          nms_thresh=self.atss_cfg.nms_thresh,
                          pre_nms_thresh=self.atss_cfg.inference_thresh)
            with record_function("predict.postprocess"):
                out = atss_postprocess(
                    flat["anchors"], tuple(flat["level_counts"]), flat["bbox_pred"][0],
                    flat["centerness"][0], flat["dot_logits"][0],
                    torch.from_numpy(label_map).to(dev),
                    image_size=(self.image_size, self.image_size), **kw)
                out = {k: v.cpu().numpy() for k, v in out.items()}
        valid = out["valid"] & (out["scores"] > self.score_thresh)
        boxes = out["boxes"][valid] / np.asarray([sx, sy, sx, sy], np.float32)
        return {
            "boxes": boxes,
            "scores": out["scores"][valid],
            "entities": [entities[l - 1] if 0 < l <= len(entities) else "?"
                         for l in out["labels"][valid]],
            "task_id": int(sel[0]),
        }


def draw_predictions(image: np.ndarray, result: dict):
    """PIL overlay of boxes + entity labels; returns a PIL Image."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(np.asarray(image, np.uint8)).convert("RGB")
    draw = ImageDraw.Draw(im)
    palette = [(255, 64, 64), (64, 200, 64), (64, 128, 255), (255, 200, 0),
               (200, 64, 255), (0, 200, 200)]
    for i, (box, score, ent) in enumerate(zip(result["boxes"], result["scores"],
                                              result["entities"])):
        color = palette[i % len(palette)]
        x1, y1, x2, y2 = [float(v) for v in box]
        draw.rectangle([x1, y1, x2, y2], outline=color, width=3)
        draw.text((x1 + 2, max(y1 - 12, 0)), f"{ent} {score:.2f}", fill=color)
    return im
