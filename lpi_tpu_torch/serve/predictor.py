"""Grounding inference predictor and visualisation (counterpart of
`lpi_tpu/serve/predictor.py`).

* `find_noun_phrases` / `run_ner`: rule-based entity extraction into char
  spans (split at verbs / prepositions, strip leading articles).
* `GroundingPredictor.predict(image, caption)`: resize and normalise,
  tokenize, build the positive map, infer the task id from frozen P7
  features with the KMeans keys, run the prompted forward, postprocess, map
  boxes back to the original image's coordinates.
* `GroundingPredictor.predict_classes(image, class_names, knowledge)`:
  GLIP-KNOW's detection mode. The class names (expanded into knowledge
  captions by `data/knowledge.py`) and an empty [NoObj] caption are
  encoded once (`forward_knowledge`); class slot i maps to itself.
* `GroundingPredictor.check_deform_clipping`: one eager forward that
  records the share of offsets beyond the windowed convs' +-deform_window
  clamp, with a warning above `warn_frac`.
* `draw_predictions`, `draw_predictions_metric`: PIL overlays, all boxes or
  the top-k above a threshold with score-graded colours.
* `launch_webui(predictor, port)`: the reference's gradio demo
  (`webui/index.py`): a caption, an image and a metric view in, the
  overlay out. `gradio` is imported when it is called, not with this
  module; without it the call raises.

`predict` runs its phases in order, each a `core.profiling.span`:
`predict.prepare` (the image's resize and normalisation on the host; read
by the benchmark's `prepare_ms.serve`), `predict.text` (NER or the custom
entity's spans, the tokenizer, the positive map; `text_ms.serve`),
`predict.upload` (the request's three arrays to the device),
`predict.task_id` and `predict.forward` (the two passes' launches),
`predict.postprocess` (`postprocess_ms.serve`), which opens with
`predict.wait`, the host's wait for the card to finish both passes
(`wait_ms.serve`; on the card only), and holds the decode, the host NMS
scan (`nms.greedy_scan`) and the copies back. The forward's graph records
the device span `graph.forward` (`forward_device_ms.serve`).
`predict_classes` runs the same phases but the task id. Without a
profiler a span costs microseconds against a request of about 45 ms.

On the card the task-id pass (`extract_features` + `infer_task_ids`) and
the prompted forward (`forward_tasks`) are each captured once as a CUDA
graph at (image_size, the tokenizer's padded length) and replayed, as the
JAX package jits `_extract` and `_fwd` apart; `forward_knowledge` is
captured once per (image_size, number of class captions, their padded
length, aggregation), as the JAX package jits it per aggregation. All are
captured with TF32
off, which fixes cuBLAS's math mode in the graphs. Image preparation, NER,
tokenizing and the postprocess with its host NMS stay outside them.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lpi_tpu_torch.continual.keys import TaskKeys, exact_fp32, infer_task_ids
from lpi_tpu_torch.core.profiling import span
from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer, positive_map_from_spans
from lpi_tpu_torch.data.knowledge import construct_knowledge_captions
from lpi_tpu_torch.data.transforms import normalize_bgr255, resize_distort
from lpi_tpu_torch.graphs import Graphed, captures
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


_HEAD_KEYS = ("bbox_pred", "centerness", "dot_logits", "anchors", "level_counts")


class GroundingPredictor:
    """Inference wrapper around a `GroundedVLModel` and its task keys.

    The model and keys are moved to `device` (the card unless the caller
    asks for the CPU). The forward runs with TF32 off, so an fp32 model
    computes in full fp32 as the JAX reference does. On the card both
    passes are captured and replayed (`eager=True` runs them op by op); the
    graphs read `keys` as it was at their capture, so assigning new keys
    captures anew.
    """

    def __init__(self, model, keys: Optional[TaskKeys] = None, tokenizer=None,
                 image_size: int = 800, score_thresh: float = 0.5,
                 atss_cfg=None, device="cuda", eager: bool = False):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.keys = keys.to(self.device) if keys is not None else None
        self.tokenizer = tokenizer or BertTokenizer()
        self.image_size = image_size
        self.score_thresh = score_thresh
        self.atss_cfg = atss_cfg
        self.capture = captures(self.device) and not eager
        self._graphs: Dict[tuple, Graphed] = {}
        self._graph_keys = None  # the keys the task-id graphs read

    def _task_ids(self, b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {"sel": infer_task_ids(self.model.extract_features(b["images"]), self.keys)}

    def _forward(self, b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        flat, _ = self.model.forward_tasks(b["images"], b["input_ids"], b["attention_mask"],
                                           b["sel"])
        return {k: flat[k] for k in _HEAD_KEYS}

    def _knowledge(self, agg_type: str):
        def run(b: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            flat, _ = self.model.forward_knowledge(b["images"], b["input_ids"],
                                                   b["attention_mask"], agg_type)
            return {k: flat[k] for k in _HEAD_KEYS}
        return run

    def _run(self, name: str, fn, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """`fn(inputs)`, eagerly or through its graph at these shapes."""
        if not self.capture:
            return fn(inputs)
        if self._graph_keys is not self.keys:
            self._graphs.clear()
            self._graph_keys = self.keys
        key = (name,) + tuple(tuple(v.shape) for v in inputs.values())
        if key not in self._graphs:
            self._graphs[key] = Graphed(fn, inputs, name=name)
        return self._graphs[key](inputs)

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

    def _upload(self, canvas: np.ndarray, ids: np.ndarray,
                mask: np.ndarray) -> Dict[str, torch.Tensor]:
        """The request's image, token ids and attention mask on the device."""
        dev = self.device
        return {"images": torch.from_numpy(canvas).to(dev),
                "input_ids": torch.from_numpy(ids).long().to(dev),
                "attention_mask": torch.from_numpy(mask).to(dev)}

    def _postprocess(self, flat: Dict[str, torch.Tensor], label_map: np.ndarray) -> dict:
        """ATSS postprocess of the first image's head outputs under
        `label_map` [entities, T]: host numpy arrays. On the card it first
        waits for the passes already launched (`predict.wait`), the wait
        that the label map's copy would otherwise make."""
        if self.device.type == "cuda":
            with span("predict.wait"):
                torch.cuda.current_stream(self.device).synchronize()
        kw = {}
        if self.atss_cfg is not None:
            n = flat["anchors"].shape[0]
            kw = dict(pre_nms_top_n=min(self.atss_cfg.pre_nms_top_n, n),
                      post_nms_top_n=min(self.atss_cfg.fpn_post_nms_top_n, n),
                      nms_thresh=self.atss_cfg.nms_thresh,
                      pre_nms_thresh=self.atss_cfg.inference_thresh)
        out = atss_postprocess(
            flat["anchors"], tuple(flat["level_counts"]), flat["bbox_pred"][0],
            flat["centerness"][0], flat["dot_logits"][0],
            torch.from_numpy(label_map).to(self.device),
            image_size=(self.image_size, self.image_size), **kw)
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _detections(self, out: dict, scale: Tuple[float, float], names: Sequence[str]) -> dict:
        """Detections over the score threshold, boxes in the original
        image's coordinates, labels as names (1-based; "?" outside)."""
        sx, sy = scale
        valid = out["valid"] & (out["scores"] > self.score_thresh)
        return {
            "boxes": out["boxes"][valid] / np.asarray([sx, sy, sx, sy], np.float32),
            "scores": out["scores"][valid],
            "entities": [names[l - 1] if 0 < l <= len(names) else "?"
                         for l in out["labels"][valid]],
        }

    @torch.no_grad()
    def check_deform_clipping(self, image: np.ndarray, caption: str = "thing",
                              warn_frac: float = 0.01) -> float:
        """One eager forward (task 0) recording each windowed or fused
        deformable conv's share of offsets beyond +-deform_window; warns
        when the largest exceeds `warn_frac`. -> that largest share (0.0
        when no conv records, as on the "exact" route)."""
        canvas, _ = self._prepare_image(image)
        ids, mask, _ = self.tokenizer([caption])
        dev = self.device
        with exact_fp32(), self.model.head.record_offset_clipping() as fracs:
            self.model.forward_tasks(torch.from_numpy(canvas).to(dev),
                                     torch.from_numpy(ids).long().to(dev),
                                     torch.from_numpy(mask).to(dev),
                                     torch.zeros((1,), dtype=torch.long, device=dev))
        worst = float(torch.stack(fracs).max()) if fracs else 0.0
        if worst > warn_frac:
            logging.getLogger("lpi_tpu_torch").warning(
                "deform offsets exceed the +-window clamp on %.1f%% of "
                "positions; consider raising deform_window or "
                "deform_impl='exact'", 100 * worst)
        return worst

    @torch.no_grad()
    def predict_classes(self, image: np.ndarray, class_names: Sequence[str],
                        knowledge: Optional[dict] = None, knowledge_type: str = "",
                        gpt3_num: int = 5, wiki_and_gpt3: bool = False,
                        agg_type: str = "first") -> dict:
        """GLIP-KNOW detection-mode inference: the class names, optionally
        expanded into knowledge captions, and the empty [NoObj] caption are
        encoded once as parallel language inputs; each class slot maps to
        itself. -> dict(boxes [K,4] original coords, scores [K], entities
        [K] class names)."""
        with span("predict.prepare"):
            canvas, scale = self._prepare_image(image)
        with span("predict.text"):
            caps = list(construct_knowledge_captions(
                class_names, knowledge, knowledge_type=knowledge_type, gpt3_num=gpt3_num,
                wiki_and_gpt3=wiki_and_gpt3)) + [""]
            ids, mask, _ = self.tokenizer(caps)
        with span("predict.upload"):
            b = self._upload(canvas, ids, mask)
        n = len(class_names)
        with exact_fp32():
            with span("predict.forward"):
                flat = self._run(f"knowledge_{agg_type}", self._knowledge(agg_type), b)
            with span("predict.postprocess"):
                out = self._postprocess(flat, np.eye(n, n + 1, dtype=np.float32))
                return self._detections(out, scale, class_names)

    @torch.no_grad()
    def predict(self, image: np.ndarray, caption: str,
                custom_entity: Optional[str] = None) -> dict:
        """-> dict(boxes [K,4] original coords, scores [K], entities [K],
        task_id)."""
        with span("predict.prepare"):
            canvas, (sx, sy) = self._prepare_image(image)
        with span("predict.text"):
            if custom_entity:
                spans = [[(m.start(), m.end())
                          for m in re.finditer(re.escape(custom_entity.lower()),
                                               caption.lower())]]
                entities = [custom_entity]
            else:
                spans, entities = run_ner(caption)
            if spans:
                ids, mask, offsets = self.tokenizer([caption])
                label_map = positive_map_from_spans(spans, offsets[0], ids.shape[1])
        if not spans:
            return {"boxes": np.zeros((0, 4)), "scores": np.zeros(0), "entities": []}
        with span("predict.upload"):
            b = self._upload(canvas, ids, mask)
        with exact_fp32():
            with span("predict.task_id"):
                if self.keys is not None:
                    sel = self._run("task_id", self._task_ids, {"images": b["images"]})["sel"]
                else:
                    sel = torch.zeros((1,), dtype=torch.long, device=self.device)
            with span("predict.forward"):
                flat = self._run("forward", self._forward, {**b, "sel": sel})
            with span("predict.postprocess"):
                out = self._postprocess(flat, label_map)
                return {**self._detections(out, (sx, sy), entities), "task_id": int(sel[0])}


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


def draw_predictions_metric(image: np.ndarray, result: dict, metric: str = "R@1",
                            thresh: float = 0.5, show_score: bool = True,
                            box_pixel: int = 3):
    """Metric view: keep the top-k detections for the recall metric
    (R@1/R@5/R@10) above `thresh`, draw each box in a score-graded colour
    (red at 0, yellow at 0.5, green at 1) with its entity, and its score at
    the box's mid-left. -> (PIL Image, the kept boxes, scores, entities)."""
    from PIL import Image, ImageDraw

    k = {"R@1": 1, "R@5": 5, "R@10": 10}.get(metric, 1)
    scores = np.asarray(result["scores"], np.float32)
    order = np.argsort(-scores)
    keep = [i for i in order if scores[i] > thresh][:k]

    im = Image.fromarray(np.asarray(image, np.uint8)).convert("RGB")
    draw = ImageDraw.Draw(im)
    for i in keep:
        s = float(scores[i])
        color = (int(255 * min(1.0, 2 * (1 - s))), int(255 * min(1.0, 2 * s)), 40)
        x1, y1, x2, y2 = [float(v) for v in result["boxes"][i]]
        draw.rectangle([x1, y1, x2, y2], outline=color, width=box_pixel)
        ent = result["entities"][i] if i < len(result["entities"]) else "?"
        draw.text((x1 + 2, max(y1 - 12, 0)), ent, fill=color)
        if show_score:
            draw.text((x1 + 2, (y1 + y2) / 2), f"{s:.3f}", fill=(255, 255, 255))
    kept = {key: [result[key][i] for i in keep] for key in ("boxes", "scores", "entities")}
    return im, kept


def launch_webui(predictor: GroundingPredictor, port: int = 7860):
    """Serve `predictor` through a gradio `Interface` on `port`: `infer(caption,
    image, metric)` draws every detection ("all", `draw_predictions`) or the
    metric view ("R@1", "R@5", "R@10", `draw_predictions_metric`). Blocks
    in `launch` while the demo serves."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError("gradio is not installed in this environment") from e

    def infer(caption, image, metric):
        image = np.asarray(image)
        result = predictor.predict(image, caption)
        if metric == "all":
            return draw_predictions(image, result)
        im, _ = draw_predictions_metric(image, result, metric=metric)
        return im

    demo = gr.Interface(
        fn=infer,
        inputs=[gr.Textbox(label="caption"), gr.Image(label="image"),
                gr.Dropdown(["all", "R@1", "R@5", "R@10"], value="all", label="metric view")],
        outputs=gr.Image(label="grounded"),
        title="LPI-TPU grounding demo",
    )
    demo.launch(server_port=port)
