"""BERT WordPiece tokenizer with character-offset tracking (host copy of
`lpi_tpu/data/bert_tokenizer.py`).

The grounding half needs (a) BERT token ids for the caption and (b) a
char-span -> token-span mapping to build the token-level positive map.
Given a standard `vocab.txt` (path argument or the `LPI_TPU_BERT_VOCAB`
environment variable) the standard lowercased WordPiece algorithm is used
(ids match bert-base-uncased). Without one, a deterministic hashed
vocabulary keeps the pipeline runnable offline: whole words hash into the
wordpiece id range and offsets still track. Unlike the JAX package, no
vocabulary is looked up under the user's home directory.
"""

from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def basic_tokenize(text: str) -> List[Tuple[str, int, int]]:
    """Lowercased whitespace+punctuation split with char offsets."""
    tokens = []
    cur = []
    start = 0
    for i, ch in enumerate(text):
        if ch.isspace():
            if cur:
                tokens.append(("".join(cur), start, i))
                cur = []
        elif _is_punct(ch):
            if cur:
                tokens.append(("".join(cur), start, i))
                cur = []
            tokens.append((ch, i, i + 1))
        else:
            if not cur:
                start = i
            cur.append(ch.lower())
    if cur:
        tokens.append(("".join(cur), start, len(text)))
    return tokens


class BertTokenizer:
    """WordPiece with offsets; hashed-id fallback when no vocab is given."""

    def __init__(self, vocab_path: Optional[str] = None, max_len: int = 256,
                 vocab_size: int = 30522):
        self.max_len = max_len
        path = vocab_path or os.environ.get("LPI_TPU_BERT_VOCAB")
        self.vocab: Optional[Dict[str, int]] = None
        if path is not None and os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
            self.vocab_size = len(self.vocab)
            self.pad_id = self.vocab[PAD]
            self.unk_id = self.vocab[UNK]
            self.cls_id = self.vocab[CLS]
            self.sep_id = self.vocab[SEP]
        else:
            self.vocab_size = vocab_size
            self.pad_id, self.unk_id, self.cls_id, self.sep_id = 0, 100, 101, 102

    def _wordpiece(self, word: str) -> List[str]:
        if self.vocab is None:
            return [word]
        if len(word) > 100:
            return [UNK]
        pieces = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def _piece_id(self, piece: str) -> int:
        if self.vocab is not None:
            return self.vocab.get(piece, self.unk_id)
        # deterministic hash into the non-special id range
        h = 2166136261
        for ch in piece.encode("utf-8"):
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        base = 1000 if self.vocab_size > 2000 else 110
        return base + h % (self.vocab_size - base)

    def encode_with_offsets(self, text: str):
        """-> (ids List[int], offsets List[(start, end)]) incl. [CLS]/[SEP]."""
        ids = [self.cls_id]
        offsets: List[Tuple[int, int]] = [(0, 0)]
        for word, ws, we in basic_tokenize(text):
            pieces = self._wordpiece(word)
            n = len(pieces)
            for k, piece in enumerate(pieces):
                # approximate per-piece char ranges by splitting the word span
                span_len = we - ws
                cs = ws + (span_len * k) // n
                ce = ws + (span_len * (k + 1)) // n if k < n - 1 else we
                ids.append(self._piece_id(piece))
                offsets.append((cs, max(ce, cs + 1)))
        ids.append(self.sep_id)
        offsets.append((0, 0))
        if len(ids) > self.max_len:
            ids = ids[: self.max_len - 1] + [self.sep_id]
            offsets = offsets[: self.max_len - 1] + [(0, 0)]
        return ids, offsets

    def __call__(self, texts: Sequence[str]):
        """-> (input_ids [B, max_len] int32, attention_mask [B, max_len],
        offsets per text)."""
        B = len(texts)
        input_ids = np.full((B, self.max_len), self.pad_id, np.int32)
        mask = np.zeros((B, self.max_len), np.float32)
        all_offsets = []
        for i, t in enumerate(texts):
            ids, offs = self.encode_with_offsets(t)
            input_ids[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1.0
            all_offsets.append(offs)
        return input_ids, mask, all_offsets


def positive_map_from_spans(
    token_spans: Sequence[Sequence[Tuple[int, int]]],
    offsets: Sequence[Tuple[int, int]],
    num_tokens: int,
) -> np.ndarray:
    """Build [G, T] positive map: GT j marks tokens overlapping any of its
    char spans (`ConvertCocoPolysToMask`/`prepare_targets` char_to_token
    behavior, with overlap replacing the exact char_to_token lookup)."""
    G = len(token_spans)
    out = np.zeros((G, num_tokens), np.float32)
    for j, spans in enumerate(token_spans):
        for beg, end in spans:
            for ti, (cs, ce) in enumerate(offsets):
                if ti >= num_tokens or ce <= cs:
                    continue
                if cs < end and beg < ce:  # overlap
                    out[j, ti] = 1.0
    return out
