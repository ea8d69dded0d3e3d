"""Detection -> grounding captions (host copy of
`lpi_tpu/data/od_grounding.py`).

Detection-mode inference turns the class-name list into one caption
("person. bicycle. car.") and a label -> token map, so that the dot-product
token head scores every class; detection-mode training labels each box with
its class name's span.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer, positive_map_from_spans


def build_detection_caption(class_names: Sequence[str],
                            separator: str = ". ") -> Tuple[str, List[Tuple[int, int]]]:
    """-> (caption, each class's char span)."""
    spans = []
    pos = 0
    for name in class_names:
        spans.append((pos, pos + len(name)))
        pos += len(name) + len(separator)
    caption = separator.join(class_names) + separator.strip()[:1]  # the trailing '.'
    return caption, spans


def create_queries_and_maps(class_names: Sequence[str], tokenizer: BertTokenizer
                            ) -> Tuple[str, np.ndarray, np.ndarray, np.ndarray]:
    """-> (caption, input_ids [1, T], attention_mask [1, T], label_token_map
    [C, T]) for detection-mode inference."""
    caption, spans = build_detection_caption(class_names)
    ids, mask, offsets = tokenizer([caption])
    label_map = positive_map_from_spans([[s] for s in spans], offsets[0], ids.shape[1])
    return caption, ids, mask, label_map


def boxes_to_grounding_targets(labels: Sequence[int], class_names: Sequence[str],
                               tokenizer: BertTokenizer) -> Tuple[str, np.ndarray]:
    """Detection-mode training targets: the caption over all class names and
    a positive map [boxes, T] marking each box's class-name span."""
    caption, spans = build_detection_caption(class_names)
    ids, _, offsets = tokenizer([caption])
    pmap = positive_map_from_spans([[spans[int(l)]] for l in labels], offsets[0], ids.shape[1])
    return caption, pmap
