"""GLIP-KNOW knowledge-augmented class prompts, host side (counterpart of
`lpi_tpu/data/knowledge.py`, of which it is a copy: the port keeps its
own).

Detection-mode class names are expanded into knowledge-augmented captions
("name: <wiki definition / GPT-3 facts>"), encoded once per class through
the language tower, and the per-class aggregated embeddings replace the
per-token language features in the dot-product head
(PARALLEL_LANGUAGE_INPUT). Here: knowledge-file loading, caption
construction, and the training-time class sampling with its positive map.
The per-class encode is `GroundedVLModel.forward_knowledge`.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def load_knowledge_file(path: str) -> Dict[str, dict]:
    """Load the class-name -> knowledge-info mapping (GLIPKNOW.KNOWLEDGE_FILE,
    a json of `{class_name: {clean_name, def_wiki, gpt3: [...], ...}}`)."""
    with open(path) as f:
        return json.load(f)


def construct_knowledge_captions(
    class_names: Sequence[str],
    knowledge: Optional[Dict[str, dict]],
    knowledge_type: str = "",
    gpt3_num: int = 5,
    wiki_and_gpt3: bool = False,
) -> List[str]:
    """Per-class caption construction
    (`generalized_vl_rcnn.py:519-551`): `"<clean_name>: <knowledge>"`,
    falling back to the bare class name when the class is missing from the
    knowledge dict or the requested knowledge field is empty."""
    captions = []
    for c in class_names:
        info = (knowledge or {}).get(c)
        if info is None or "clean_name" not in info:
            captions.append(c)
            continue
        cap = info["clean_name"]
        try:
            if wiki_and_gpt3:
                # def_wiki then the first gpt3_num GPT-3 facts, concatenated
                # with no separator (faithful to `:530-534`)
                know_seq = info["def_wiki"]
                know_seq += " ".join(seq for seq in info["gpt3"][:gpt3_num])
                cap += ": " + know_seq
            elif knowledge_type and info.get(knowledge_type):
                val = info[knowledge_type]
                if knowledge_type == "gpt3" or isinstance(val, list):
                    know_seq = " ".join(seq for seq in val[:gpt3_num])
                else:
                    know_seq = val
                cap += ": " + know_seq
        except (KeyError, TypeError):
            cap = c  # reference swallows any lookup error (`:544-547`)
        captions.append(cap)
    return captions


def sample_training_classes(
    label_names_per_image: Sequence[Sequence[str]],
    class_name_list: Sequence[str],
    max_classes: int,
    rng: np.random.RandomState,
) -> Tuple[List[str], np.ndarray]:
    """Training-time class-batch sampling + positive map
    (`generalized_vl_rcnn.py:555-593`).

    Returns `(shuffled_class_names [max_classes], positive_map
    [total_boxes, max_classes + 1])` — the last column is the [NoObj] slot
    (left 0; negatives fall back to it in the ATSS token labels).
    """
    if max_classes >= len(class_name_list):
        shuffled = list(class_name_list)
        rng.shuffle(shuffled)
        if max_classes > len(shuffled):
            shuffled.extend(shuffled[:max_classes - len(shuffled)])
            rng.shuffle(shuffled)
    else:
        # unique labels in encounter order across the batch, truncated, then
        # padded with random negative classes
        label_list: List[str] = []
        seen = set()
        for labels in label_names_per_image:
            for label in labels:
                if label not in seen:
                    seen.add(label)
                    label_list.append(label)
        label_list = label_list[:max_classes]
        if len(label_list) < max_classes:
            negatives = [c for c in class_name_list if c not in seen]
            idx = rng.choice(len(negatives), max_classes - len(label_list),
                             replace=False)
            label_list.extend(negatives[i] for i in idx)
        rng.shuffle(label_list)
        shuffled = label_list

    slot = {l: i for i, l in enumerate(shuffled)}
    total_boxes = sum(len(labels) for labels in label_names_per_image)
    positive_map = np.zeros((total_boxes, max_classes + 1), np.float32)
    off = 0
    for labels in label_names_per_image:
        for label in labels:
            j = slot.get(label, -1)
            if j >= 0:
                positive_map[off, j] = 1.0
            off += 1
    return shuffled, positive_map
